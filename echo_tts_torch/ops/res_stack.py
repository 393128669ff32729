"""The codec's three dilated residual units: plain version and the wrapper
of the hand-written Hopper kernel (csrc/res_stack.cu, kernel B).

Counterpart of echo_tts_tpu/ops/pallas/res_stack.py; the kernel replaces
`_res_stack_kernel`.  What bounds it on the H100 is the bf16 tensor-core
rate (2 * 8 * C^2 FLOP per frame and unit); the design, in the .cu file's
source note: one launch per unit, so that a block of BM rows needs only
its own 6 * d frames of context; snake1 of the tile in shared memory; the
k7 and k1 convs on wgmma with the rows (shifted by tap * d) from shared
memory through ldmatrix and the weights streamed by TMA through a ring of
stages, each weight byte serving BM rows; the snakes as passes over the
tile, outside the matrix loop.  `tile_plan` is that kernel's plan, in
Python, so that the CPU tests can check it.

`fused_res_stack` takes the plain version (three residual units at the
kernel's rounding points) for CPU tensors and launches the kernel for CUDA
tensors (or raises).  Its weights come as a `ResStackWeights`: the JAX
layout, w1 (3, 7, C, C) as (unit, tap, C_in, C_out), w2 (3, C, C) as
(unit, C_in, C_out), biases and snake alphas (3, C), which keeps its
kernel-layout copy so that a caller who holds it pays that copy once.

The history form (streaming decode and encode, models/dac/streaming.py):
with `history`, three (B, 6 * d, C) tensors in x's dtype holding the
previous block's last 6 * d rows of snake1 of each unit's input, a context
row at position p < 0 of unit d reads history[u][:, 6 * d + p] (already
snake1'd) where the one-shot form reads zero, and the call returns
(out, new_history): the last 6 * d rows of [history | snake1(x_u)] of each
unit, which the kernel writes out from its own shared-memory tile (the
block holding rows [L - 6 * d, L)), so that the next block reads the
values this launch computed.  Those calls count in
`fused_res_stack.launches_stream`, the one-shot ones in
`fused_res_stack.launches`.

The centred form (Descript's DAC decoder, `centred=True`): each unit's k7
conv pads 3 * d on each side, so a block of BM rows reads the 3 * d rows
before it and the 3 * d after it, the same BM + 6 * d rows of tile as the
causal form, 39 frames of halo on each side over the stack.  With
`lengths` (B,) int32, each item's rows at or past its length are read as
zero and written as zero, so that a batch of ragged items runs as each
alone at its own length (models/dac/conv.py `mask_tail`).  It is a
template instance of its own in the .cu file (CENTRED), one-shot only, so
the causal instances compile as before; its calls count in
`fused_res_stack.launches_centred`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .activations import sin2_poly
from ..utils import programs

# Canonical dilation schedule of the codec's residual units
# (reference: autoencoder.py:887-891).
DILATIONS = (1, 3, 9)
HALO = 6 * sum(DILATIONS)                 # the stack's 78 frames of left context
KERNEL_WIDTHS = (64, 96, 128, 192, 256, 384)  # instantiated in res_stack.cu
SMEM_LIMIT = 232448                        # bytes a block may use on sm_90
SMEM_SM = 233472                           # an SM's, of which 1024 per block reserved


def res_stack_eligible(x: torch.Tensor) -> bool:
    """Whether the kernel takes x: a CUDA tensor at C <= 384, the widths it
    is built for, at any length (it masks ragged tiles and zero-pads the
    context before the sequence start).  The JAX package also asks for
    L >= 4096 (res_stack.py:48-57), a TPU heuristic; here every streamed
    block (L = 256, 1024, 2048 frames per latent at C = 384, 192, 96)
    runs the kernel too."""
    return x.is_cuda and x.shape[2] <= KERNEL_WIDTHS[-1]


def _snake_f32(v: torch.Tensor, alpha: torch.Tensor, approx: bool) -> torch.Tensor:
    """Snake computed in fp32 and cast back to v's dtype (res_stack.py:76-88)."""
    vf, af = v.float(), alpha.float()
    z = af * vf
    s2 = sin2_poly(z) if approx else torch.square(torch.sin(z))
    return (vf + (1.0 / (af + 1e-9)) * s2).to(v.dtype)


def residual_unit_plain(x, w1, b1, a1, w2, b2, a2, dil: int,
                        approx_snake: bool = False, history=None,
                        centred: bool = False, lengths=None):
    """One residual unit (models/dac/conv.py:residual_unit) at the Pallas
    kernel's rounding points (res_stack.py:90-111), which the CUDA kernel
    keeps: snake in fp32 then cast; each conv from working-dtype inputs with
    fp32 accumulation, + bias, then cast; the residual add in the working
    dtype.  w1 (7, C_in, C_out), w2 (C_in, C_out), vectors (C,).  In fp32
    this is exactly `residual_unit`.

    With `history` (B, 6 * dil, C), the previous block's tail of snake1(x),
    as the k7 conv's context in place of zeros, returns (out, new history),
    the last 6 * dil rows of [history | snake1(x)] in x's dtype.

    `centred`: the k7 conv's context is 3 * dil zeros on each side, and
    with `lengths` (B,) each item's rows at or past its length are zero in
    snake1(x) and in the output (the module docstring)."""
    dt, length = x.dtype, x.shape[1]
    y = _snake_f32(x, a1, approx_snake)
    keep = None
    if lengths is not None:
        keep = (torch.arange(length, device=x.device)[None]
                < lengths[:, None])[..., None].to(dt)
        y = y * keep
    if centred:
        y = F.pad(y, (0, 0, 3 * dil, 3 * dil))
    elif history is None:
        y = F.pad(y, (0, 0, 6 * dil, 0))
    else:
        y = torch.cat([history.to(dt), y], dim=1)
        new_history = y[:, y.shape[1] - 6 * dil:].clone()
    y = y.float()
    w = w1.float()
    z = y[:, 0:length] @ w[0]
    for k in range(1, 7):
        z = z + y[:, k * dil:k * dil + length] @ w[k]
    z = _snake_f32((z + b1.float()).to(dt), a2, approx_snake)
    out = x + (z.float() @ w2.float() + b2.float()).to(dt)
    if keep is not None:
        out = out * keep
    return out if history is None else (out, new_history)


def res_stack_plain(x, w1, b1, a1, w2, b2, a2, approx_snake: bool = False,
                    history=None, centred: bool = False, lengths=None):
    """The three units, d = 1, 3, 9, one after the other, as the kernel runs
    them (one launch each); weights stacked over the unit axis.  With
    `history` (three tensors) returns (out, [three new histories]);
    `centred` and `lengths` as in residual_unit_plain."""
    new_history = []
    for u, dil in enumerate(DILATIONS):
        if history is None:
            x = residual_unit_plain(x, w1[u], b1[u], a1[u], w2[u], b2[u],
                                    a2[u], dil, approx_snake,
                                    centred=centred, lengths=lengths)
        else:
            x, h = residual_unit_plain(x, w1[u], b1[u], a1[u], w2[u], b2[u],
                                       a2[u], dil, approx_snake, history[u])
            new_history.append(h)
    return x if history is None else (x, new_history)


def tile_plan(c: int) -> dict:
    """The kernel's plan at kernel width c (csrc/res_stack.cu `Plan`):
    `bm` rows a block (two warpgroups of 64 rows and every output channel,
    or at C > 256 one 64-row tile split over C_out, `ns` = 2, so that each
    warpgroup holds C / ns fp32 accumulators a thread); C_in padded to
    `kp`, whole 64-channel panels; a ring of `stages` weight panels of
    `stage_bytes` (C_out rows of 64 bf16), as many as fit, at most 4,
    beside the tile buffer at the largest dilation, within `smem_budget`:
    a block's limit, or half an SM's shared memory where an SM holds
    `blocks_per_sm` = 2 blocks (C <= 128, whose accumulators fit the 128
    registers a thread that leaves)."""
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"C={c} is not one of the kernel's widths "
                         f"{KERNEL_WIDTHS}")
    ns = 2 if c > 256 else 1
    bm = 64 * (2 // ns)
    stage = c * 128
    per_sm = 2 if c <= 128 else 1
    budget = SMEM_LIMIT if per_sm == 1 else SMEM_SM // per_sm - 1024
    y_max = (bm + 6 * max(DILATIONS)) * (c + 8) * 2
    stages = min(4, (budget - 1024 - y_max - 16 * c - 64) // stage)
    return dict(bm=bm, ns=ns, kp=-(-c // 64) * 64, stages=stages,
                stage_bytes=stage, blocks_per_sm=per_sm, smem_budget=budget)


def smem_bytes(c: int, dil: int) -> int:
    """Dynamic shared memory of one block of the unit with dilation dil:
    1024 for alignment, the weight ring, the tile with its 6 * dil context
    rows (bf16, rows padded to c + 8), both snakes' alpha and 1 / (alpha +
    1e-9) in fp32, the ring's two mbarriers a stage."""
    p = tile_plan(c)
    return (1024 + p["stages"] * p["stage_bytes"]
            + (p["bm"] + 6 * dil) * (c + 8) * 2 + 16 * c
            + 2 * p["stages"] * 8)


def unit_blocks(c: int, length: int, dil: int) -> list:
    """The blocks of the launch of the unit with dilation dil, in grid
    order: (first row read, first output row, output rows).  A block reads
    its rows and the 6 * dil before them (zero, or the history, before the
    sequence start), and the kernel's tile buffer holds bm + 6 * dil rows.
    The last block's tile holds rows [L - 6 * dil, L), the new history,
    which it writes out in the history form."""
    bm = tile_plan(c)["bm"]
    return [(r0 - 6 * dil, r0, min(bm, length - r0))
            for r0 in range(0, length, bm)]


class ResStackWeights:
    """The three units' weights, stacked in the JAX layout: w1 (3, 7, C, C)
    as (unit, tap, C_in, C_out), w2 (3, C, C) as (unit, C_in, C_out), biases
    and snake alphas (3, C).

    `kernel_layout()` pads them to the kernel's width and transposes the
    convs to (C_out, C_in) once, at the first launch, and keeps that copy:
    the tensors must not change after it."""

    def __init__(self, w1, b1, a1, w2, b2, a2):
        self.w1, self.b1, self.a1, self.w2, self.b2, self.a2 = (
            w1, b1, a1, w2, b2, a2)
        self._kernel = None

    def plain_args(self) -> tuple:
        return self.w1, self.b1, self.a1, self.w2, self.b2, self.a2

    def kernel_layout(self) -> tuple:
        """(cp, w1t, w2t, b1, a1, b2, a2): the width the kernel runs at, the
        convs (3, 7, cp, kp) and (3, cp, kp) bf16 as (unit, [tap,] C_out,
        C_in), C_in zero-padded to whole 64-channel panels (`tile_plan`'s
        kp: the K-major rows TMA loads for wgmma's B), the vectors (3, cp)
        fp32."""
        if self._kernel is None:
            w1, w2 = self.w1, self.w2
            c = w1.shape[-1]
            if w1.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
                raise TypeError("the residual-stack kernel takes bf16 "
                                f"weights; got {w1.dtype}, {w2.dtype}")
            if c > KERNEL_WIDTHS[-1]:
                raise ValueError(f"C={c} exceeds the kernel's widths "
                                 f"{KERNEL_WIDTHS}")
            vecs = (self.b1, self.a1, self.b2, self.a2)
            if (w1.shape != (3, 7, c, c) or w2.shape != (3, c, c)
                    or any(v.shape != (3, c) for v in vecs)):
                raise ValueError(f"weights {tuple(w1.shape)}, "
                                 f"{tuple(w2.shape)} or biases/alphas do "
                                 f"not match C={c}")
            cp = next(w for w in KERNEL_WIDTHS if w >= c)
            pad, kpad = cp - c, tile_plan(cp)["kp"] - c
            self._kernel = (
                cp,
                F.pad(w1, (0, pad, 0, kpad)).transpose(2, 3).contiguous(),
                F.pad(w2, (0, pad, 0, kpad)).transpose(1, 2).contiguous(),
                *(F.pad(v.float(), (0, pad)).contiguous() for v in vecs))
        return self._kernel


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _dense16(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy: the kernel reads rows of 8 bf16 (16 bytes)
    at a time, so it needs dense, 16-byte aligned tensors (a fresh or
    padded copy always is)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


_CENTRED_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])


def _launch(x: torch.Tensor, weights: ResStackWeights, approx_snake: bool,
            history=None, centred: bool = False, lengths=None):
    batch, length, c = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the residual-stack kernel takes bf16 activations; "
                        f"got {x.dtype}")
    if weights.w1.shape[-1] != c:
        raise ValueError(f"x has C={c}, the weights "
                         f"C={weights.w1.shape[-1]}")
    cp, w1t, w2t, b1, a1, b2, a2 = weights.kernel_layout()
    pad = cp - c
    xk = _dense16(F.pad(x, (0, pad)) if pad else x)
    # the three units run x -> out -> tmp -> out
    out, tmp = torch.empty_like(xk), torch.empty_like(xk)
    plan = tile_plan(cp)
    fn = (cuda_build.entry("res_stack", "echo_res_stack_centred_bf16",
                           _CENTRED_ARGTYPES) if centred else
          cuda_build.entry("res_stack", "echo_res_stack_bf16", _ARGTYPES))
    buffers = (xk.data_ptr(), tmp.data_ptr(), out.data_ptr(), w1t.data_ptr(),
               b1.data_ptr(), a1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
               a2.data_ptr())
    shape = (batch, length, cp, plan["bm"], plan["stages"],
             int(bool(approx_snake)),
             torch.cuda.current_stream(x.device).cuda_stream)
    if centred:
        lens = None
        if lengths is not None:
            if tuple(lengths.shape) != (batch,):
                raise ValueError(f"lengths {tuple(lengths.shape)} must be "
                                 f"({batch},)")
            lens = lengths.to(device=x.device,
                              dtype=torch.int32).contiguous()
        rc = fn(*buffers, None if lens is None else lens.data_ptr(), *shape)
        cuda_build.check(rc, "res_stack")
        fused_res_stack.launches_centred += 1
        return out[..., :c] if pad else out
    hist_in = hist_out = [None] * 3
    if history is not None:
        hist_in = [_dense16(F.pad(h, (0, pad)) if pad else h) for h in history]
        hist_out = [torch.empty_like(h) for h in hist_in]

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = fn(*buffers, *(ptr(h) for h in hist_in),
            *(ptr(h) for h in hist_out), *shape)
    cuda_build.check(rc, "res_stack")
    out = out[..., :c] if pad else out
    if history is None:
        fused_res_stack.launches += 1
        return out
    fused_res_stack.launches_stream += 1
    return out, [h[..., :c] if pad else h for h in hist_out]


def fused_res_stack(x: torch.Tensor, weights: ResStackWeights, *,
                    approx_snake: bool = False, history=None,
                    centred: bool = False, lengths=None):
    """Apply the three dilated residual units to x (B, L, C).

    With `history` (three tensors (B, 6 * d, C) in x's dtype, d = 1, 3, 9)
    returns (out, new_history), the history form of the module docstring.
    CPU tensors run `res_stack_plain`; CUDA tensors launch the kernel, one
    launch per unit, and count the call (one per stack) in
    `fused_res_stack.launches`, or `.launches_stream` for the history
    form.  Raises, on every device, when grad mode is on and an input
    requires grad: the kernel has no backward, and its output must never
    be a tensor cut from the graph.

    `centred` (with `lengths` (B,) or None) runs the centred form of the
    module docstring, one-shot only; its calls count in
    `fused_res_stack.launches_centred`."""
    if centred and history is not None:
        raise ValueError("the centred form has no history form")
    if lengths is not None and not centred:
        raise ValueError("lengths are taken by the centred form only")
    if history is not None:
        if len(history) != len(DILATIONS):
            raise ValueError(f"history holds {len(history)} tensors, not "
                             f"{len(DILATIONS)}")
        for h, dil in zip(history, DILATIONS):
            want = (x.shape[0], 6 * dil, x.shape[2])
            if tuple(h.shape) != want or h.dtype != x.dtype:
                raise ValueError(f"history {tuple(h.shape)} {h.dtype} must "
                                 f"be {want} {x.dtype}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights.plain_args(), *(history or ()))):
        raise RuntimeError(
            "the residual-stack kernel has no gradient (the JAX package "
            "never differentiates it); call it under torch.no_grad() or "
            "torch.inference_mode(), or on tensors that do not require grad")
    if x.device.type == "cpu":
        return res_stack_plain(x, *weights.plain_args(), approx_snake,
                               history, centred=centred, lengths=lengths)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, weights, approx_snake, history, centred, lengths)


fused_res_stack.launches = 0
fused_res_stack.launches_stream = 0
fused_res_stack.launches_centred = 0
# exact under CUDA-graph replay (utils/programs.py)
programs.register_counters(fused_res_stack, "launches", "launches_stream",
                           "launches_centred")
