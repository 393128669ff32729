"""Int8 quantization for the opt-in serving modes: the W8A8 DiT and the int8
static K/V.

Counterpart of echo_tts_tpu/ops/quant.py.  Both modes are non-parity (the
reference has no quantization) and off by default:

  * W8A8: the eight hot-loop weights of every DiT block
    (`DIT_BLOCK_QUANT_KEYS`) become symmetric per-output-channel int8 with
    fp32 scales; activations are quantized per row inside `int8_dot`,
    which launches the hand-written kernel C (csrc/int8_matmul.cu) for
    CUDA tensors and runs the plain version for CPU tensors.
  * int8 static K/V: `quantize_kv_int8` stores the prefilled K/V int8 with
    per-(token, head) scales that the joint-attention kernel folds into its
    per-column K/V scales.

The JAX `qdot` dispatches on the parameter leaf's type; here the module's
type does: `quantize_dit` swaps those `nn.Linear`s for `Int8Linear`s
whose forward is `int8_dot`, so the DiT's forward code keeps one path for
both modes.  The port's weights are (N, K) (nn.Linear's (out, in)), so
every per-output-channel scale reduces over the last axis, which gives
the numbers the JAX package gets over axis -2 of its (K, N).

The K-halves int4 packing (W4A8, a rejected mode kept for checkpoint
compatibility) is here too, and quantization-aware training: `qat_dot`
(W8A8 fake quantization in fp32 with straight-through gradients) and
`qat_tag_dit_params`, a view of the DiT whose hot-loop linears run
through it while sharing the plain model's parameters.

Under tensor parallelism (parallel/mesh.py) a row-parallel layer holds a
K-slice of its weight: `int8_dot_row_parallel` and `qat_dot_row_parallel`
take the activation row's abs-max over the whole K (an all-reduce MAX
over the model group, as GSPMD takes it over the sharded K in the JAX
package), so that every slice quantizes as the unsharded product does.
The W8A8 slices' int32 sums are then all-reduced and rescaled once, which
equals the unsharded product exactly; the per-output-channel weight
scale, taken over the whole K before sharding, stays whole.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.mesh import TP_ATTR
from .int8_matmul import (int8_matmul_fused, int8_matmul_partial,
                          int8_rescale, quantize_last)

# The hot-loop weights of each DiT block: applied to (G*B, S, .) rows on
# every sampler step (ops/quant.py:116-120 of the JAX package).
DIT_BLOCK_QUANT_KEYS = (
    ("attention", "wq"), ("attention", "wk"), ("attention", "wv"),
    ("attention", "gate"), ("attention", "wo"),
    ("mlp", "w1"), ("mlp", "w2"), ("mlp", "w3"),
)
KV_Q8_KEYS = ("k8", "ks", "v8", "vs")


def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N, K) weight -> (int8 (..., N, K), fp32 scale (..., N)), the
    scale being each output channel's abs-max over K / 127."""
    q, scale = quantize_last(w, 127.0)
    return q.to(torch.int8), scale


def dequantize_weight(q8: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_weight_int8 (up to rounding)."""
    return (q8.float() * scale[..., None]).to(dtype)


# x @ dequant(w8)^T with dynamic per-row int8 activation quantization:
# x (..., K) float, w8 (N, K) int8, w_scale (N,) fp32 -> (..., N) in
# out_dtype (default x's).  Kernel C for CUDA tensors, its plain version for
# CPU tensors: the JAX package's int8_dot and int8_matmul_fused compute one
# function, so the port has one (ops/int8_matmul.py).
int8_dot = int8_matmul_fused


def _global_scale127(a: torch.Tensor, group, keepdim: bool = False
                     ) -> torch.Tensor:
    """max(abs-max over the last axis of every slice in `group`, 1e-12) /
    127, fp32, detached (a true division, as quantize_last's)."""
    amax = a.detach().float().abs().amax(-1, keepdim=keepdim)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)


def int8_dot_row_parallel(x: torch.Tensor, w8: torch.Tensor,
                          w_scale: torch.Tensor, group,
                          out_dtype=None) -> torch.Tensor:
    """int8_dot of a row-parallel layer: x (..., K / tp) and w8 (N, K / tp)
    are this rank's K-slices, w_scale (N,) whole.  The row scale comes from
    the whole K, kernel C's row-parallel instance gives the slice's int32
    sums, their all-reduce the whole product's, and one rescale the
    result: the unsharded int8_dot's, bit for bit."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    x_scale = _global_scale127(x, group)
    acc = int8_matmul_partial(x, w8, x_scale)
    dist.all_reduce(acc, group=group)
    return int8_rescale(acc, x_scale, w_scale, out_dtype)


# ---------------------------------------------------------------------------
# W4A8: K-halves nibble packing (byte r = w[r] | (w[r + K/2] << 4) along K)
# ---------------------------------------------------------------------------

def quantize_weight_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N, K) weight -> (packed int8 (..., N, K/2), fp32 scale (..., N)),
    values in [-7, 7].  Row r of K pairs with row r + K/2, so the unpack is
    a concatenation.  Needs an even K."""
    q, scale = quantize_last(w, 7.0)
    half = q.shape[-1] // 2
    if 2 * half != q.shape[-1]:
        raise ValueError(f"int4 packing needs an even K, got {tuple(q.shape)}")
    q = q.to(torch.int32)
    packed = (q[..., :half] & 0xF) | ((q[..., half:] & 0xF) << 4)
    # two's-complement wrap into int8, as the JAX package's astype does
    packed = torch.where(packed > 127, packed - 256, packed)
    return packed.to(torch.int8), scale


def unpack_weight_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., N, K/2) packed int8 -> (..., N, K) int8 in [-7, 7]: the low
    nibble is sign-extended, the high one comes out of one arithmetic
    shift."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def int4_dot(x: torch.Tensor, w4p: torch.Tensor, w_scale: torch.Tensor,
             out_dtype=None) -> torch.Tensor:
    """The W4A8 twin of int8_dot: unpack, then int8_dot."""
    return int8_dot(x, unpack_weight_int4(w4p), w_scale, out_dtype)


# ---------------------------------------------------------------------------
# Quantized linears and the DiT transforms
# ---------------------------------------------------------------------------

class Int8Linear(nn.Module):
    """A bias-free linear with an int8 (N, K) weight and one fp32 scale per
    output channel; forward is `int8_dot`."""
    quantize = staticmethod(quantize_weight_int8)
    dot = staticmethod(int8_dot)

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "Int8Linear":
        if linear.bias is not None:
            raise ValueError("only bias-free linears are quantized")
        if hasattr(linear, TP_ATTR):
            raise ValueError("quantize the DiT before sharding it: a "
                             "row-parallel slice's channel scales would "
                             "cover its K-slice only")
        return cls(*cls.quantize(linear.weight))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dot(x, self.weight, self.scale)


class Int4Linear(Int8Linear):
    """As Int8Linear with a K-halves packed int4 (N, K/2) weight."""
    quantize = staticmethod(quantize_weight_int4)
    dot = staticmethod(int4_dot)


def _copy_module(mod: nn.Module) -> nn.Module:
    """A new module object holding the same children, whose table of
    children can be edited without touching `mod`."""
    new = copy.copy(mod)
    new._modules = dict(mod._modules)
    return new


def _map_hot_linears(model: nn.Module,
                     convert: Callable[[nn.Module], nn.Module]) -> nn.Module:
    """A new EchoDiT whose DIT_BLOCK_QUANT_KEYS leaves are convert(leaf);
    every other submodule is shared with `model` by reference."""
    out = _copy_module(model)
    blocks = []
    for blk in model.blocks:
        new_blk = _copy_module(blk)
        for group in dict.fromkeys(g for g, _ in DIT_BLOCK_QUANT_KEYS):
            new_blk._modules[group] = _copy_module(blk._modules[group])
        for group, key in DIT_BLOCK_QUANT_KEYS:
            parent = new_blk._modules[group]
            parent._modules[key] = convert(parent._modules[key])
        blocks.append(new_blk)
    out._modules["blocks"] = nn.ModuleList(blocks)
    return out


def quantize_dit(model: nn.Module) -> nn.Module:
    """The W8A8 DiT (counterpart of quantize_dit_params): a new EchoDiT in
    which the eight hot-loop linears of every block are Int8Linear.
    Everything else (encoders, static-KV projections, AdaLN, norms, in/out
    projections, cond MLP) is shared by reference.  Idempotent: a leaf that
    is already Int8Linear is kept."""
    return _map_hot_linears(model, lambda m: m if isinstance(m, Int8Linear)
                            else Int8Linear.from_linear(m))


def quantize_dit_int4(model: nn.Module) -> nn.Module:
    """quantize_dit, int4 edition (the same hot-loop leaves; a leaf that is
    already quantized either way is kept)."""
    return _map_hot_linears(model, lambda m: m if isinstance(m, Int8Linear)
                            else Int4Linear.from_linear(m))


def dit_is_quantized(model: nn.Module) -> bool:
    """True iff every hot-loop leaf of every block is Int8Linear, False iff
    none is; raises on a mixed model, which must not be served with mixed
    bf16/int8 numerics."""
    states: Dict[str, bool] = {
        f"blocks.{i}.{g}.{k}": type(blk._modules[g]._modules[k]) is Int8Linear
        for i, blk in enumerate(model.blocks) for g, k in DIT_BLOCK_QUANT_KEYS}
    if all(states.values()):
        return True
    if not any(states.values()):
        return False
    quantized = sorted(k for k, v in states.items() if v)
    raise ValueError(
        f"partially quantized DiT: quantized leaves {quantized} but not the "
        "rest; run quantize_dit on the whole model")


# ---------------------------------------------------------------------------
# Int8 static K/V
# ---------------------------------------------------------------------------

def quantize_kv_int8(k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Static K/V pair (L, B, T, H, Dh) -> {"k8", "ks", "v8", "vs"}: int8
    arrays and fp32 per-(L, B, T, H) scales over the head dimension."""
    k8, ks = quantize_last(k, 127.0)
    v8, vs = quantize_last(v, 127.0)
    return {"k8": k8.to(torch.int8), "ks": ks,
            "v8": v8.to(torch.int8), "vs": vs}


def dequantize_kv(q: Dict[str, torch.Tensor], dtype=torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of quantize_kv_int8 (up to rounding)."""
    k = (q["k8"].float() * q["ks"][..., None]).to(dtype)
    v = (q["v8"].float() * q["vs"][..., None]).to(dtype)
    return k, v


def kv_is_quantized(kv) -> bool:
    return isinstance(kv, dict) and all(x in kv for x in KV_Q8_KEYS)


# ---------------------------------------------------------------------------
# Quantization-aware training (ops/quant.py:300-348): the forward takes
# int8_dot's quantization decisions (per-output-channel weights, per-row
# activations, symmetric 127) in fp32 arithmetic, and gradients pass
# straight through the rounding (the scales are detached).  It never
# launches kernel C, which has no gradient.
# ---------------------------------------------------------------------------

class _RoundClipSTE(torch.autograd.Function):
    """clip(round_ste(v), -127, 127) as the JAX package computes it,
    v + stop_gradient(round(v) - v) then jnp.clip, whose maximum and
    minimum each give half the gradient to a tie: the gradient is 1 inside
    the range, 1/2 at exactly -127 or 127, 0 outside.  The backward keeps
    that multiplier in bf16 (0, 1/2 and 1 are exact), not the fp32
    operands autograd would keep (QAT's memory at full size)."""

    @staticmethod
    def forward(ctx, v):
        r = v + (torch.round(v) - v)
        ctx.save_for_backward(((r.abs() < 127.0).to(torch.bfloat16)
                               + 0.5 * (r.abs() == 127.0).to(torch.bfloat16)))
        return torch.clamp(r, -127.0, 127.0)

    @staticmethod
    def backward(ctx, grad):
        (mult,) = ctx.saved_tensors
        return grad * mult


def _scale127(a: torch.Tensor) -> torch.Tensor:
    """max(abs-max over the last axis, 1e-12) / 127, detached, (..., 1);
    a true division on every device (see quantize_last)."""
    amax = a.detach().abs().amax(-1, keepdim=True).clamp_min(1e-12)
    return amax / torch.full_like(amax, 127.0)


def qat_dot(x: torch.Tensor, w: torch.Tensor, *,
            x_scale: torch.Tensor = None,
            w_scale: torch.Tensor = None) -> torch.Tensor:
    """x @ w^T, w (N, K) as nn.Linear holds it, with W8A8 fake
    quantization on both operands; int8_dot's values up to fp32 against
    int32 accumulation; the result in x's dtype.  d/dw is the plain
    product's gradient inside the clip range (straight through).  The
    scales ((..., 1) and (N, 1) fp32) are taken here unless given."""
    xf = x.float()
    x_scale = _scale127(xf) if x_scale is None else x_scale
    xq = _RoundClipSTE.apply(xf / x_scale)
    wf = w.float()
    w_scale = _scale127(wf) if w_scale is None else w_scale
    wq = _RoundClipSTE.apply(wf / w_scale)
    out = torch.matmul(xq, wq.transpose(-1, -2)) * x_scale * w_scale[..., 0]
    return out.to(x.dtype)


def qat_dot_row_parallel(x: torch.Tensor, w: torch.Tensor,
                         group) -> torch.Tensor:
    """qat_dot of a row-parallel layer's K-slices, both scales taken over
    the whole K; the caller sums the partial products over `group`."""
    return qat_dot(x, w, x_scale=_global_scale127(x, group, keepdim=True),
                   w_scale=_global_scale127(w, group, keepdim=True))


class QATLinear(nn.Module):
    """A bias-free linear whose forward is qat_dot; it holds the plain
    linear's weight Parameter itself, so an optimizer over the plain model
    updates what it reads, and its tensor-parallel mark."""

    def __init__(self, linear: nn.Module):
        super().__init__()
        if type(linear) is not nn.Linear or linear.bias is not None:
            raise TypeError(f"QAT takes bias-free nn.Linear leaves, got "
                            f"{type(linear).__name__}")
        self.weight = linear.weight
        if hasattr(linear, TP_ATTR):
            setattr(self, TP_ATTR, getattr(linear, TP_ATTR))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qat_dot(x, self.weight)


def qat_tag_dit_params(model: nn.Module) -> nn.Module:
    """The QAT view of a DiT (counterpart of qat_tag_dit_params): a new
    EchoDiT whose DIT_BLOCK_QUANT_KEYS leaves are QATLinear over the same
    Parameters, every other submodule shared by reference.  Built inside
    the loss, so that the optimizer keeps the plain model."""
    return _map_hot_linears(model, QATLinear)
