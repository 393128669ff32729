"""The (data, model) device mesh, the DiT's tensor-parallel layout and the
collectives its forward runs.

Counterpart of echo_tts_tpu/parallel/mesh.py.  JAX places whole arrays
with NamedShardings and lets GSPMD insert the collectives; here sharding
is explicit (Megatron's): a `torch.distributed.device_mesh.DeviceMesh`
with dims ("data", "model"), each rank holding only its own shards as
plain tensors, and the forward calling `all_reduce` over the model group
after each row-parallel projection.  Kernels A and C therefore run on
plain local tensors.

The layout (the port's nn.Linear stores weights (out, in), the JAX package
(in, out), so the split dims are transposed):

  * column-parallel: attention wq/wk/wv/gate, the static-KV projections
    wk_*/wv_*, SwiGLU w1/w3 split weight dim 0 (output channels, i.e.
    heads or hidden units) over "model";
  * row-parallel: wo and w2 split weight dim 1 (input channels); their
    outputs are partial sums, all-reduced over "model";
  * q_norm/k_norm (H, Dh) split the head axis;
  * everything else (norms, AdaLN, embeddings, in/out projections, the
    timestep MLP) is replicated;
  * activations and KV caches: the rows of the rank's data coordinate,
    the heads of its model coordinate.

A tower (the DiT blocks, the text encoder, the speaker encoder, the
blockwise latent encoder) shards only when its head count and its MLP
width both divide the model axis; otherwise it runs replicated on every
rank, as `_divisible_spec` replicates the leaves that do not divide in the
JAX package.  At tp = 4 the 10-head text and speaker encoders run
replicated; at tp = 3 everything does.

Under grad the collectives are Megatron's pair of autograd Functions:
`copy_to_model` (identity forward, all-reduce backward) on the replicated
input of the column-parallel projections, and `reduce_from_model`
(all-reduce forward, identity backward) on the row-parallel outputs.
A row-parallel product's partial sums stay fp32 (bf16 operands, fp32
accumulation and output), are summed in fp32 and rounded once to the
activation dtype, as the unsharded product rounds its fp32 accumulator
once.

Programs over a mesh.  The mesh cores (the Euler sampler, the train and
distill steps and the sequence-parallel speaker prefill) run as captured
programs (utils/programs.py) whose scope is their mesh
(`program_scope`).  Their collectives (the row-parallel all-reduces, the
gradients' all-reduce over "data", the W8A8 MAX and int32 all-reduces,
the prefill's all-gather) are recorded into the CUDA graph as they are,
each a device-side collective into a tensor the body made:

  * the key holds the mesh's identity and this rank's coordinates
    (`mesh_key`), and the program keeps the mesh alive, so that a program
    never replays on another mesh, even an equal one: a graph replays the
    communicators it was captured with;
  * on a card every process group of the mesh must be NCCL, whose
    collectives are device work a graph records; gloo's run on the host,
    and a capture would record none of them.  Such a call raises before
    it runs anything, naming the backend (`capture_refusal`); it does not
    run the body eagerly instead.  On the CPU nothing is captured, and
    the body runs over gloo as every call does there;
  * a graph that recorded an NCCL collective holds its communicator:
    NCCL's finalisation of a communicator waits until every such graph
    is destroyed.  So the mesh programs go before the process group
    (`drop_programs`): `parallel.distributed.shutdown` drops them and then
    destroys the group, and a process that never calls it drops them at
    exit, before the interpreter frees the groups (an atexit hook
    registered with the first scope).

`gather_params` stays outside every program: checkpoint writing is host
work.
"""
from __future__ import annotations

import atexit
import gc
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..config import EchoDiTConfig
from ..utils import programs

DATA_AXIS = "data"
MODEL_AXIS = "model"

# set by shard_params on every module it split: "col", "row" or "heads"
TP_ATTR = "_echo_tp"

COL = (MODEL_AXIS, None)     # split weight dim 0 (output channels)
ROW = (None, MODEL_AXIS)     # split weight dim 1 (input channels)
HEADS = (MODEL_AXIS, None)   # split the (H, Dh) QK-norm's head axis
REP = ()


class ShardCoords(NamedTuple):
    """A shard's place in a (dp, tp) mesh, without a process group: what
    `shard_params`, `batch_spec` and `kv_cache_spec` need, so that one
    process can lay out every shard in turn.  A forward under it runs no
    collective and so takes only tp = 1."""
    dp: int = 1
    tp: int = 1
    data: int = 0
    model: int = 0


Mesh = Union["torch.distributed.device_mesh.DeviceMesh", ShardCoords]


def make_mesh(*, dp: Optional[int] = None, tp: Optional[int] = None):
    """The (data, model) DeviceMesh over every rank of the initialized
    process group: rank r sits at (r // tp, r % tp).  With neither dp nor
    tp given every rank goes to data parallelism (the serving default:
    requests are independent).  Its device type is "cuda" under NCCL,
    else "cpu" (gloo, which also takes CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if tp is None and dp is None:
        dp, tp = n, 1
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != device count {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_coords(mesh: Mesh) -> ShardCoords:
    """(dp, tp, data index, model index) of this rank in `mesh`."""
    if isinstance(mesh, ShardCoords):
        return mesh
    return ShardCoords(mesh.size(0), mesh.size(1),
                       mesh.get_local_rank(DATA_AXIS),
                       mesh.get_local_rank(MODEL_AXIS))


def mesh_key(mesh: Mesh) -> tuple:
    """What a captured program's key holds of its mesh, as the JAX
    package's lru keys hold the hashable Mesh: a DeviceMesh's identity and
    this rank's coordinates; a ShardCoords is a value and keys as itself
    (module docstring, "Programs over a mesh")."""
    if isinstance(mesh, ShardCoords):
        return ("coords", mesh)
    return ("mesh", id(mesh), mesh_coords(mesh))


def mesh_backends(mesh: Mesh) -> Tuple[str, ...]:
    """The backend of each axis's process group ("nccl", "gloo", ...);
    none for a ShardCoords, which has no process group."""
    if isinstance(mesh, ShardCoords):
        return ()
    return tuple(dist.get_backend(mesh.get_group(axis))
                 for axis in (DATA_AXIS, MODEL_AXIS))


def capture_refusal(mesh: Optional[Mesh], device) -> Optional[str]:
    """Why a program over `mesh` cannot be captured on `device`, or None
    when it can: on a card every process group of the mesh must be NCCL
    (module docstring).  No mesh, a ShardCoords (no process group) and
    the CPU are never refused."""
    if mesh is None or torch.device(device).type != "cuda":
        return None
    other = sorted({b for b in mesh_backends(mesh) if b != "nccl"})
    if not other:
        return None
    return (f"a program over a mesh whose process group backend is "
            f"{other[0]!r} cannot be captured on {device}: a CUDA graph "
            "records NCCL's collectives, not those that run on the host. "
            "Join the ranks over NCCL, or call the entry point's .eager "
            "form")


_AT_EXIT = []


class MeshScope:
    """A mesh as a program's scope (utils/programs.py, "Scoped programs"):
    its key part and its refusal; the program holds it, and so the mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.key = mesh, mesh_key(mesh)
        if not _AT_EXIT:
            _AT_EXIT.append(atexit.register(drop_programs))

    def check(self, device) -> None:
        refusal = capture_refusal(self.mesh, device)
        if refusal is not None:
            raise RuntimeError(refusal)


def program_scope(mesh: Optional[Mesh]) -> Optional[MeshScope]:
    """The scope a mesh core passes to its program cache: None without a
    mesh."""
    return None if mesh is None else MeshScope(mesh)


def drop_programs() -> None:
    """Drop every program over a mesh and free its graph now (module
    docstring): before the process group is destroyed."""
    programs.drop_scoped()
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _group(mesh: Mesh, axis: str):
    """The process group along `axis`, or None where that axis has size 1
    (no collective runs)."""
    c = mesh_coords(mesh)
    if (c.tp if axis == MODEL_AXIS else c.dp) == 1:
        return None
    if isinstance(mesh, ShardCoords):
        raise ValueError(f"a ShardCoords mesh has no process group for its "
                         f"'{axis}' axis of size > 1; make the mesh with "
                         "make_mesh in an initialized process group")
    return mesh[axis].get_group()


def model_group(mesh: Mesh):
    return _group(mesh, MODEL_AXIS)


def data_group(mesh: Mesh):
    return _group(mesh, DATA_AXIS)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` in fp32, rounded once to x's dtype (a new tensor)."""
    y = x.float().clone() if x.dtype == torch.float32 else x.float()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_fp32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The replicated input of column-parallel projections: x itself in the
    forward; under grad, its gradient (each rank's partial) is summed over
    the model group."""
    group = None if mesh is None else model_group(mesh)
    if group is None or not _grad_path(x):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A row-parallel projection's partial output, summed over the model
    group (fp32, one rounding); the gradient passes through unchanged."""
    group = None if mesh is None else model_group(mesh)
    if group is None:
        return x
    if _grad_path(x):
        return _ReduceFromModel.apply(x, group)
    return all_reduce_fp32(x, group)


def is_sharded(module: nn.Module) -> bool:
    return getattr(module, TP_ATTR, None) is not None


def sharded_params(model: nn.Module) -> frozenset:
    """The ids of the parameters that shard_params split."""
    return frozenset(id(p) for m in model.modules() if is_sharded(m)
                     for p in m.parameters(recurse=False))


def row_parallel(linear: nn.Module, x: torch.Tensor,
                 mesh: Optional[Mesh]) -> torch.Tensor:
    """linear(x) for a linear that may be row-parallel: its partial output
    summed over the model group.  The W8A8 and QAT forms take the row's
    activation scale over the whole K (an all-reduce MAX) first, as GSPMD
    does, so that the sharded product quantizes as the unsharded one."""
    if mesh is None or getattr(linear, TP_ATTR, None) != "row":
        return linear(x)
    from ..ops import quant
    group = model_group(mesh)
    if isinstance(linear, quant.Int4Linear):
        raise NotImplementedError("the int4 DiT does not run tensor-parallel")
    if isinstance(linear, quant.Int8Linear):
        return quant.int8_dot_row_parallel(x, linear.weight, linear.scale,
                                           group)
    if isinstance(linear, quant.QATLinear):
        return reduce_from_model(
            quant.qat_dot_row_parallel(x, linear.weight, group), mesh)
    return reduce_from_model(_linear_fp32(x, linear.weight), mesh).to(x.dtype)


class _LinearFp32Out(torch.autograd.Function):
    """x @ w^T for bf16 operands on CUDA with the fp32 accumulator as the
    output (torch.mm's out_dtype, which has no derivative); the backward
    runs the products in x's dtype, as nn.Linear's does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.reshape(-1, w.shape[0]).to(x.dtype)
        gx = (g @ w).reshape(x.shape) if ctx.needs_input_grad[0] else None
        gw = (g.t() @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


def _linear_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T accumulated and returned in fp32, not rounded to x's dtype:
    on CUDA the bf16 product with an fp32 output, elsewhere the fp32
    product of the upcast operands."""
    if x.dtype == torch.float32:
        return F.linear(x, w)
    if not x.is_cuda:
        return F.linear(x.float(), w.float())
    return _LinearFp32Out.apply(x, w)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

_ATTN_COL = ("wq", "wk", "wv", "gate", "wk_text", "wv_text", "wk_speaker",
             "wv_speaker", "wk_latent", "wv_latent")


def _towers(cfg: EchoDiTConfig) -> Dict[str, Tuple[int, int]]:
    """{state-dict prefix: (heads, MLP width)} of each block tower."""
    towers = {"blocks.": (cfg.num_heads, cfg.intermediate_size),
              "text_encoder.": (cfg.text_num_heads, cfg.text_intermediate_size),
              "speaker_encoder.": (cfg.speaker_num_heads,
                                   cfg.speaker_intermediate_size)}
    if cfg.blockwise:
        towers["latent_encoder."] = (cfg.speaker_num_heads,
                                     cfg.speaker_intermediate_size)
    return towers


def sharded_towers(cfg: EchoDiTConfig, tp: int) -> Tuple[str, ...]:
    """The towers whose heads and MLP width both divide tp (the rest run
    replicated)."""
    return tuple(p for p, (h, inter) in _towers(cfg).items()
                 if h % tp == 0 and inter % tp == 0)


def _leaf_spec(key: str) -> tuple:
    """The spec of one state-dict key inside a block tower."""
    parts = key.split(".")
    if len(parts) < 3 or parts[-1] not in ("weight", "scale"):
        return REP
    group, name = parts[-3], parts[-2]
    if group == "attention":
        if name in _ATTN_COL:
            return COL
        if name == "wo":
            return ROW
        if name in ("q_norm", "k_norm"):
            return HEADS
    if group == "mlp":
        return ROW if name == "w2" else COL
    return REP


def dit_param_specs(model: nn.Module, tp: Optional[int] = None
                    ) -> Dict[str, tuple]:
    """{state-dict key: spec} for an EchoDiT (plain or W8A8): a spec names
    the mesh axis of each weight dim, () for replicated.  With tp, the
    towers that do not divide tp are replicated (module docstring).  A
    W8A8 scale (N,) splits with a column-parallel weight and stays whole
    with a row-parallel one."""
    towers = tuple(_towers(model.cfg)) if tp is None else sharded_towers(
        model.cfg, tp)
    specs = {}
    for key in model.state_dict():
        spec = _leaf_spec(key) if key.startswith(towers) else REP
        if key.endswith(".scale") and spec == ROW:
            spec = REP
        specs[key] = spec
    return specs


def _slice(n: int, parts: int, i: int) -> slice:
    if n % parts:
        raise ValueError(f"dimension {n} does not divide {parts} shards")
    per = n // parts
    return slice(i * per, (i + 1) * per)


def to_named(specs: Dict[str, tuple], mesh: Mesh,
             shapes: Dict[str, Sequence[int]]) -> Dict[str, tuple]:
    """{key: index}: the block of each leaf this rank holds (a tuple of
    slices, one per dim), the spec met with the mesh as a NamedSharding
    meets one in the JAX package."""
    c = mesh_coords(mesh)
    parts = {DATA_AXIS: (c.dp, c.data), MODEL_AXIS: (c.tp, c.model)}
    out = {}
    for key, spec in specs.items():
        shape = shapes[key]
        idx = []
        for d, n in enumerate(shape):
            ax = spec[d] if d < len(spec) else None
            idx.append(slice(None) if ax is None else _slice(n, *parts[ax]))
        out[key] = tuple(idx)
    return out


def kv_cache_spec(mesh: Mesh, batch: int, num_heads: int
                  ) -> Tuple[slice, slice]:
    """(rows, heads) of an (L, B, T, H, Dh) KV cache this rank holds: its
    data coordinate's rows and its model coordinate's heads."""
    c = mesh_coords(mesh)
    return _slice(batch, c.dp, c.data), _slice(num_heads, c.tp, c.model)


def batch_spec(mesh: Mesh, batch: int) -> slice:
    """The rows of a batch-leading activation this rank holds."""
    c = mesh_coords(mesh)
    if batch % c.dp:
        raise ValueError(f"batch {batch} must divide the '{DATA_AXIS}' axis "
                         f"({c.dp})")
    return _slice(batch, c.dp, c.data)


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's blocks of the DiT's parameters, in place, and free
    the rest (each kept block is a copy, so the whole tensor goes with its
    last reference).  Every split module is marked (TP_ATTR) for the
    forward; a model already sharded is returned as it is.  Returns
    `model`."""
    from ..ops.quant import Int8Linear

    c = mesh_coords(mesh)
    if c.tp == 1 or any(is_sharded(m) for m in model.modules()):
        return model
    specs = dit_param_specs(model, c.tp)
    state = model.state_dict()
    index = to_named(specs, mesh, {k: v.shape for k, v in state.items()})
    for name, mod in model.named_modules():
        key = f"{name}.weight"
        spec = specs.get(key, REP)
        if spec == REP:
            continue
        kind = "heads" if key.endswith("_norm.weight") else (
            "row" if spec == ROW else "col")
        w = mod.weight[index[key]].clone()
        if isinstance(mod, Int8Linear):
            mod.weight = w
            mod.scale = mod.scale[index[f"{name}.scale"]].clone()
        else:
            mod.weight = nn.Parameter(w, requires_grad=mod.weight.requires_grad)
            if isinstance(mod, nn.Linear):
                mod.out_features, mod.in_features = w.shape
        setattr(mod, TP_ATTR, kind)
    return model


@torch.no_grad()
def gather_params(model: nn.Module, mesh: Optional[Mesh]
                  ) -> Dict[str, torch.Tensor]:
    """The whole state dict of a sharded DiT, its split leaves all-gathered
    over the model group (every rank of the group must call this); the
    state dict itself when `mesh` is None or tp = 1."""
    state = model.state_dict()
    group = None if mesh is None else model_group(mesh)
    if group is None:
        return state
    tp = mesh_coords(mesh).tp
    out = {}
    for name, mod in model.named_modules():
        kind = getattr(mod, TP_ATTR, None)
        if kind is None:
            continue
        dim = 1 if kind == "row" else 0
        keys = [f"{name}.weight"]
        if kind == "col" and f"{name}.scale" in state:
            keys.append(f"{name}.scale")
        for key in keys:
            local = state[key].contiguous()
            parts = [torch.empty_like(local) for _ in range(tp)]
            dist.all_gather(parts, local, group=group)
            out[key] = torch.cat(parts, dim=dim)
    return {k: out.get(k, v) for k, v in state.items()}
