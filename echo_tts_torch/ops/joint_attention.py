"""Joint attention over [self | static K/V]: plain version and the wrapper
of the hand-written Hopper kernel (csrc/joint_attention.cu).

Counterpart of echo_tts_tpu/ops/pallas/joint_attention.py.  The kernel
replaces both Pallas kernels there (`_kernel`, whole-row, and
`_flash_kernel`, online softmax): one tiled online-softmax kernel serves
every shape, because the whole-row form existed only to fit the TPU's VMEM.
Its design and what bounds it on the H100 are in the source note of the
.cu file; `_tile_plan` picks its query tile.

`fused_joint_attention` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (or raises); it never falls back.
Layouts are the JAX package's: q/k_self/v_self (GB, S, H, Dh) with the GB
axis G-major over the KV batch B, static K/V (B, T, H, Dh), the static
mask (GB, T) bool (True = attend) and an optional (T,) column scale that
multiplies the static logits (K side) and the static weights (V side).
Static K/V may be int8 (the opt-in KV mode, ops/quant.quantize_kv_int8)
with `kv_scales=(ks, vs)`, (B, T, H) fp32: their per-column products with
the column scale become the K and V scales.  Launches of that form are
counted apart, in `fused_joint_attention.launches_kv8`.

Gradients: where grad mode is on and an input requires grad, the forward
runs inside `_KernelWithPlainGrad`, whose backward recomputes through
`joint_attention_plain` under autograd, as the JAX package's custom VJP
recomputes through `_xla_attention` (joint_attention.py:404-434).  Its
forward is one dispatcher op, `torch.ops.echo_tts.joint_attention` (the
plain version for CPU tensors, the kernel's launch for CUDA tensors), so
that a selective activation checkpoint can save its output by name
(models/dit.py, remat "attn" and "dots_all").  The int8 form has no
gradient: it raises.  Calls without grad launch the kernel directly:
through the Function a call costs the host 10-23 us more (chip_smoke.py's
paired count on an H100 80GB HBM3 at 700 W), on a sampler pass of 960
calls that the host bounds.

Under a (data, model) mesh the kernel runs per shard with no collective:
a sharded DiT holds its rank's heads and rows and calls
`fused_joint_attention` on them; `fused_joint_attention_sharded` cuts a
shard out of whole inputs (joint_attention.py:524-596).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build
from ..utils import programs

MASK_VALUE = -1e30
KERNEL_HEAD_DIM = 128   # the DiT's; the only one csrc/joint_attention.cu takes


def joint_attention_plain(q, k_self, v_self, k_static, v_static, static_mask,
                          col_scale=None, *, sm_scale: float,
                          kv_scales=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, mirroring `_xla_attention`
    (joint_attention.py:366-400): fp32 logits, one softmax over
    [self | static], the column scale applied to the static weights after
    the denominator, e cast to the V dtype before PV with fp32
    accumulation.  static_mask (GB, T) bool; col_scale (T,) or None;
    int8 static K/V are cast to q's dtype (exact) and kv_scales (B, T, H)
    fp32 multiply into the K and V column scales."""
    gb, s, h, dh = q.shape
    b, t = k_static.shape[:2]
    g = gb // b
    bias = torch.where(static_mask, 0.0, MASK_VALUE).float()
    scale = (torch.ones((t,), dtype=torch.float32, device=q.device)
             if col_scale is None else col_scale.float())
    kscale = vscale = scale
    if kv_scales is not None:
        k_static, v_static = k_static.to(q.dtype), v_static.to(q.dtype)
        # (B, T, H) -> (1, B, H, 1, T), one fp32 product with the column scale
        kscale, vscale = (
            (scale * x.float().permute(0, 2, 1)).reshape(1, b, h, 1, t)
            for x in kv_scales)
    qg = q.float().reshape(g, b, s, h, dh)
    ls = torch.einsum("gbshd,gbthd->gbhst", qg,
                      k_self.float().reshape(g, b, s, h, dh)) * sm_scale
    lt = torch.einsum("gbshd,bthd->gbhst", qg, k_static.float()) * sm_scale
    lt = lt * kscale + bias.reshape(g, b, 1, 1, t)
    m = torch.maximum(ls.amax(-1, keepdim=True), lt.amax(-1, keepdim=True))
    e_self = torch.exp(ls - m)
    e_st = torch.exp(lt - m)
    denom = e_self.sum(-1, keepdim=True) + e_st.sum(-1, keepdim=True)
    acc = torch.einsum("gbhst,gbthd->gbhsd", e_self.to(v_self.dtype).float(),
                       v_self.float().reshape(g, b, s, h, dh))
    acc = acc + torch.einsum("gbhst,bthd->gbhsd",
                             (e_st * vscale).to(v_static.dtype).float(),
                             v_static.float())
    out = (acc / denom).to(q.dtype)                  # (G, B, H, S, Dh)
    return out.permute(0, 1, 3, 2, 4).reshape(gb, s, h, dh)


QUERY_TILE = 128   # query rows per block of kernel A


def _tile_plan(gb: int, s: int, h: int) -> int:
    """Query rows per block of kernel A, one block per (q-tile, head, gb)
    and one block per SM: 128, two consumer warpgroups that take turns on
    the tensor cores, at every shape.  Where that gives fewer blocks than
    SMs (GB = 1, S = 640: 80), it runs in one partial wave; why no smaller
    tile does better is in the source note of csrc/joint_attention.cu."""
    return QUERY_TILE


_SIZES = ([ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_ARGTYPES = [ctypes.c_void_p] * 8 + _SIZES
_ARGTYPES_KV8 = [ctypes.c_void_p] * 10 + _SIZES


def _aligned(x: torch.Tensor) -> bool:
    """TMA's terms: a 16-byte-aligned base, the head dim contiguous and
    every other stride a multiple of 16 bytes (8 bf16, or 16 int8)."""
    per_16b = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % per_16b == 0 for st in x.stride()[:-1]))


def _dense(x: torch.Tensor) -> torch.Tensor:
    """x, or a contiguous 16-byte-aligned copy of it."""
    if x.is_contiguous() and _aligned(x):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _launch(q, k_self, v_self, k_static, v_static, static_mask, col_scale,
            sm_scale: float, kv_scales=None) -> torch.Tensor:
    gb, s, h, dh = q.shape
    b, t = k_static.shape[:2]
    kv_dtype = torch.bfloat16 if kv_scales is None else torch.int8
    tensors = (q, k_self, v_self, k_static, v_static)
    if any(x.dtype != torch.bfloat16 for x in tensors[:3]) or any(
            x.dtype != kv_dtype for x in tensors[3:]):
        raise TypeError("the joint-attention kernel takes bf16 q/k/v and "
                        "bf16, or int8 with kv_scales, static K/V; got "
                        f"{[str(x.dtype) for x in tensors]}")
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {dh}: the kernel takes {KERNEL_HEAD_DIM}")
    dev = q.device
    extra = (static_mask,) if col_scale is None else (static_mask, col_scale)
    extra += () if kv_scales is None else tuple(kv_scales)
    if any(x.device != dev for x in (*tensors, *extra)):
        raise ValueError("joint attention inputs on different devices")
    if static_mask.dtype != torch.bool:
        raise TypeError(f"static_mask must be bool, got {static_mask.dtype}")
    # the kernel reads the mask and the column scale as dense vectors
    mask = static_mask.contiguous()
    scale = None if col_scale is None else col_scale.float().contiguous()
    # q, k_self, v_self and out share one set of strides; the static K/V
    # are read through their own (which k and v share)
    q, k_self, v_self = (_dense(x) for x in (q, k_self, v_self))
    if not (_aligned(k_static) and k_static.stride() == v_static.stride()
            and _aligned(v_static)):
        k_static, v_static = _dense(k_static), _dense(v_static)
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(),
            k_static.data_ptr(), v_static.data_ptr(), mask.data_ptr(),
            None if scale is None else scale.data_ptr()]
    if kv_scales is None:
        fn = cuda_build.entry("joint_attention", "echo_joint_attention_bf16",
                              _ARGTYPES)
    else:
        # the kernel indexes the (B, T, H) scales densely
        deq = [x.float().contiguous() for x in kv_scales]
        ptrs += [x.data_ptr() for x in deq]
        fn = cuda_build.entry("joint_attention", "echo_joint_attention_kv8",
                              _ARGTYPES_KV8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*ptrs, out.data_ptr(), gb, s, h, dh, b, t, *q.stride()[:3],
            *k_static.stride()[:3], float(sm_scale), _tile_plan(gb, s, h),
            stream)
    cuda_build.check(rc, "joint_attention")
    # the temporaries made here may be freed once this returns: the caching
    # allocator hands their memory only to work queued later on this stream
    if kv_scales is None:
        fused_joint_attention.launches += 1
    else:
        fused_joint_attention.launches_kv8 += 1
    return out


@torch.library.custom_op("echo_tts::joint_attention", mutates_args=())
def joint_attention_op(q: torch.Tensor, k_self: torch.Tensor,
                       v_self: torch.Tensor, k_static: torch.Tensor,
                       v_static: torch.Tensor, static_mask: torch.Tensor,
                       col_scale: Optional[torch.Tensor],
                       sm_scale: float) -> torch.Tensor:
    """The forward under grad as one op: the plain version for CPU
    tensors, the kernel's launch (counted) for CUDA tensors."""
    if q.device.type == "cpu":
        return joint_attention_plain(q, k_self, v_self, k_static, v_static,
                                     static_mask, col_scale, sm_scale=sm_scale)
    return _launch(q, k_self, v_self, k_static, v_static, static_mask,
                   col_scale, sm_scale)


class _KernelWithPlainGrad(torch.autograd.Function):
    """`forward_fn` (the kernel's launch) in the forward; in the backward,
    joint_attention_plain recomputed under autograd and differentiated, so
    that q, k_self, v_self, the float static K/V and the column scale get
    the plain version's gradients."""

    @staticmethod
    def forward(ctx, forward_fn, sm_scale, q, k_self, v_self, k_static,
                v_static, static_mask, col_scale):
        ctx.sm_scale = sm_scale
        ctx.save_for_backward(q, k_self, v_self, k_static, v_static,
                              static_mask, col_scale)
        return forward_fn(q, k_self, v_self, k_static, v_static, static_mask,
                          col_scale, sm_scale)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [x.detach().requires_grad_() if need else x
                    for x, need in zip(ctx.saved_tensors, needs)]
            out = joint_attention_plain(*args, sm_scale=ctx.sm_scale)
            grads = iter(torch.autograd.grad(
                out, [a for a, need in zip(args, needs) if need], grad_out))
        return (None, None, *(next(grads) if need else None for need in needs))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in tensors)


def fused_joint_attention(q: torch.Tensor, k_self: torch.Tensor,
                          v_self: torch.Tensor, k_static: torch.Tensor,
                          v_static: torch.Tensor, static_mask: torch.Tensor,
                          col_scale: Optional[torch.Tensor] = None, *,
                          sm_scale: float,
                          kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]]
                          = None) -> torch.Tensor:
    """Joint attention (GB, S, H, Dh) -> (GB, S, H, Dh) in q's dtype.

    Static K/V are q's dtype, or int8 with kv_scales = (ks, vs), each
    (B, T, H) fp32.  CPU tensors run `joint_attention_plain`; CUDA tensors
    launch the kernel and count the launch in
    `fused_joint_attention.launches` (bf16 static K/V) or
    `fused_joint_attention.launches_kv8` (int8).  Under grad, the float
    form carries the plain version's gradient on both devices (module
    docstring); the int8 form raises."""
    gb, s, h, dh = q.shape
    b, t = k_static.shape[:2]
    if (k_self.shape != q.shape or v_self.shape != q.shape
            or k_static.shape != (b, t, h, dh) or v_static.shape != k_static.shape):
        raise ValueError(f"q/k_self/v_self {tuple(q.shape)}, "
                         f"{tuple(k_self.shape)}, {tuple(v_self.shape)} and "
                         f"static K/V {tuple(k_static.shape)}, "
                         f"{tuple(v_static.shape)} do not match")
    if gb % b or static_mask.shape != (gb, t):
        raise ValueError(f"q batch {gb} must be a multiple of the KV batch "
                         f"{b}; static_mask {tuple(static_mask.shape)} must "
                         f"be ({gb}, {t})")
    int8_kv = k_static.dtype == torch.int8 and v_static.dtype == torch.int8
    if (kv_scales is not None) != int8_kv or not (
            int8_kv or (k_static.is_floating_point()
                        and v_static.is_floating_point())):
        raise TypeError(f"static K/V {k_static.dtype}/{v_static.dtype}: "
                        "float without kv_scales, or int8 with them")
    if kv_scales is not None and any(x.shape != (b, t, h) for x in kv_scales):
        raise ValueError(f"kv_scales {[tuple(x.shape) for x in kv_scales]} "
                         f"must be ({b}, {t}, {h}) each")
    if col_scale is not None and col_scale.shape != (t,):
        raise ValueError(f"col_scale {tuple(col_scale.shape)} must be ({t},)")
    grad = _needs_grad(q, k_self, v_self, k_static, v_static, col_scale)
    if grad and kv_scales is not None:
        raise RuntimeError("joint attention over int8 static K/V has no "
                           "gradient; run it without grad, or with bf16 or "
                           "fp32 static K/V")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if grad:
        return _KernelWithPlainGrad.apply(joint_attention_op, sm_scale, q,
                                          k_self, v_self, k_static, v_static,
                                          static_mask, col_scale)
    if q.device.type == "cpu":
        return joint_attention_plain(q, k_self, v_self, k_static, v_static,
                                     static_mask, col_scale, sm_scale=sm_scale,
                                     kv_scales=kv_scales)
    return _launch(q, k_self, v_self, k_static, v_static, static_mask,
                   col_scale, sm_scale, kv_scales)


fused_joint_attention.launches = 0
fused_joint_attention.launches_kv8 = 0
# exact under CUDA-graph replay (utils/programs.py)
programs.register_counters(fused_joint_attention, "launches", "launches_kv8")


# ---------------------------------------------------------------------------
# Per shard of a (data, model) mesh (joint_attention.py:524-596)
# ---------------------------------------------------------------------------

def shardable(mesh, kv_batch: int, num_heads: int) -> bool:
    """Whether kernel A splits evenly over `mesh` (parallel.mesh): the KV
    batch divides the data axis and the heads the model axis."""
    from ..parallel.mesh import mesh_coords
    c = mesh_coords(mesh)
    return kv_batch % c.dp == 0 and num_heads % c.tp == 0


def shard_query_rows(gb: int, kv_batch: int, dp: int, data: int
                     ) -> torch.Tensor:
    """The query rows of data coordinate `data`: {g * B + b : b in its KV
    rows} for every CFG branch g, in G-major order.  Contiguous GB / dp
    rows would split the branches from their KV row, and the kernel's
    b % B broadcast would read another request's static K/V."""
    per = kv_batch // dp
    rows = torch.arange(data * per, (data + 1) * per)
    return (torch.arange(gb // kv_batch)[:, None] * kv_batch
            + rows[None, :]).reshape(-1)


def fused_joint_attention_sharded(
        q: torch.Tensor, k_self: torch.Tensor, v_self: torch.Tensor,
        k_static: torch.Tensor, v_static: torch.Tensor,
        static_mask: torch.Tensor, col_scale: Optional[torch.Tensor] = None, *,
        sm_scale: float, mesh,
        kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
) -> torch.Tensor:
    """Kernel A on this rank's shard of whole (unsharded) inputs: the KV
    rows of its data coordinate with their query rows in every CFG branch
    (`shard_query_rows`), and the heads of its model coordinate; no
    collective (the kernel is parallel over its (row, head) grid).  Returns
    the shard's output, (G * B / dp, S, H / tp, Dh), which equals those rows
    and heads of the unsharded call.  `mesh` is a DeviceMesh or a
    parallel.mesh.ShardCoords (one process laying out each shard in turn).
    A model that already holds its shard (models/dit.py under a mesh) calls
    fused_joint_attention on it directly."""
    from ..parallel.mesh import kv_cache_spec, mesh_coords
    gb, _, h, _ = q.shape
    b = k_static.shape[0]
    if not shardable(mesh, b, h):
        raise ValueError(f"KV batch {b} and {h} heads do not split over "
                         f"(dp, tp) = {mesh_coords(mesh)[:2]}")
    c = mesh_coords(mesh)
    kv_rows, heads = kv_cache_spec(mesh, b, h)
    rows = shard_query_rows(gb, b, c.dp, c.data).to(q.device)

    def qs(x):
        return x.index_select(0, rows)[:, :, heads]

    scales = (None if kv_scales is None
              else tuple(x[kv_rows, :, heads] for x in kv_scales))
    return fused_joint_attention(
        qs(q), qs(k_self), qs(v_self), k_static[kv_rows, :, heads],
        v_static[kv_rows, :, heads], static_mask.index_select(0, rows),
        col_scale, sm_scale=sm_scale, kv_scales=scales)
