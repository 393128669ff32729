"""The codec's three dilated residual units: plain version and the wrapper
of the hand-written Hopper kernel (csrc/res_stack.cu).

Counterpart of echo_tts_tpu/ops/pallas/res_stack.py.  The kernel replaces
`_res_stack_kernel`; its design (one block per L-tile that reads its own
78-frame context, weights from L2, the k7 conv's output kept in registers
as the k1 conv's input) and what bounds it are in the source note of the
.cu file.

`fused_res_stack` takes the plain version (three residual units at the
kernel's rounding points) for CPU tensors and launches the kernel for CUDA
tensors (or raises).  Its weights come as a `ResStackWeights`: the JAX
layout, w1 (3, 7, C, C) as (unit, tap, C_in, C_out), w2 (3, C, C) as
(unit, C_in, C_out), biases and snake alphas (3, C), which keeps its
kernel-layout copy so that a caller who holds it pays that copy once.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .activations import sin2_poly

# Canonical dilation schedule of the codec's residual units
# (reference: autoencoder.py:887-891).
DILATIONS = (1, 3, 9)
HALO = 6 * sum(DILATIONS)                 # 78 frames of left context
KERNEL_WIDTHS = (64, 96, 128, 192, 256, 384)  # instantiated in res_stack.cu
SMEM_LIMIT = 232448                        # bytes a block may use on sm_90
_PAD = 8                                   # bf16 row padding in the kernel


def res_stack_eligible(x: torch.Tensor) -> bool:
    """Whether the kernel takes x: a CUDA tensor at C <= 384, the widths it
    is built for, at any length (it masks ragged tiles and zero-pads the
    context before the sequence start).  The JAX package also asks for
    L >= 4096 (res_stack.py:48-57), a TPU heuristic; here every short
    block, as streaming decode will give, runs the kernel too."""
    return x.is_cuda and x.shape[2] <= KERNEL_WIDTHS[-1]


def _snake_f32(v: torch.Tensor, alpha: torch.Tensor, approx: bool) -> torch.Tensor:
    """Snake computed in fp32 and cast back to v's dtype (res_stack.py:76-88)."""
    vf, af = v.float(), alpha.float()
    z = af * vf
    s2 = sin2_poly(z) if approx else torch.square(torch.sin(z))
    return (vf + (1.0 / (af + 1e-9)) * s2).to(v.dtype)


def res_stack_plain(x, w1, b1, a1, w2, b2, a2, approx_snake: bool = False):
    """Three residual units (models/dac/conv.py:residual_unit) at the Pallas
    kernel's rounding points (res_stack.py:90-111), which the CUDA kernel
    keeps: snake in fp32 then cast; each conv from working-dtype inputs with
    fp32 accumulation, + bias, then cast; the residual add in the working
    dtype.  In fp32 this is exactly the unrolled `residual_unit`s."""
    dt, length = x.dtype, x.shape[1]
    for u, dil in enumerate(DILATIONS):
        y = F.pad(_snake_f32(x, a1[u], approx_snake), (0, 0, 6 * dil, 0)).float()
        w = w1[u].float()
        z = y[:, 0:length] @ w[0]
        for k in range(1, 7):
            z = z + y[:, k * dil:k * dil + length] @ w[k]
        z = _snake_f32((z + b1[u].float()).to(dt), a2[u], approx_snake)
        x = x + (z.float() @ w2[u].float() + b2[u].float()).to(dt)
    return x


def block_length(c: int) -> int:
    """Frames per block: the largest multiple of 16 whose tile plus its
    78-frame context fits twice (X and snake(X)) in shared memory."""
    rows = SMEM_LIMIT // (2 * (c + _PAD) * 2)
    return min(1024, (rows - HALO) // 16 * 16)


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
        convs (3, 7, Cout, Cin) and (3, Cout, Cin) bf16 (the mma B fragments
        are contiguous pairs of C_in), the vectors (3, cp) fp32."""
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
            pad = cp - c
            self._kernel = (
                cp,
                F.pad(w1, (0, pad, 0, pad)).transpose(2, 3).contiguous(),
                F.pad(w2, (0, pad, 0, pad)).transpose(1, 2).contiguous(),
                *(F.pad(v.float(), (0, pad)).contiguous() for v in vecs))
        return self._kernel


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _launch(x: torch.Tensor, weights: ResStackWeights,
            approx_snake: bool) -> torch.Tensor:
    batch, length, c = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the residual-stack kernel takes bf16 activations; "
                        f"got {x.dtype}")
    if weights.w1.shape[-1] != c:
        raise ValueError(f"x has C={c}, the weights "
                         f"C={weights.w1.shape[-1]}")
    cp, w1t, w2t, b1, a1, b2, a2 = weights.kernel_layout()
    pad = cp - c
    # rows of 8 bf16 (16 bytes) are read at a time: x must be dense and
    # aligned (a padded copy always is)
    xk = F.pad(x, (0, pad)) if pad else x
    if not xk.is_contiguous() or xk.data_ptr() % 16:
        xk = xk.clone(memory_format=torch.contiguous_format)
    out = torch.empty_like(xk)
    lib = cuda_build.load("res_stack")
    fn = lib.echo_res_stack_bf16
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(xk.data_ptr(), out.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
            a1.data_ptr(), w2t.data_ptr(), b2.data_ptr(), a2.data_ptr(),
            batch, length, cp, block_length(cp), int(bool(approx_snake)),
            stream)
    cuda_build.check(rc, "res_stack")
    fused_res_stack.launches += 1
    return out[..., :c] if pad else out


def fused_res_stack(x: torch.Tensor, weights: ResStackWeights, *,
                    approx_snake: bool = False) -> torch.Tensor:
    """Apply the three dilated residual units to x (B, L, C).

    CPU tensors run `res_stack_plain`; CUDA tensors launch the kernel and
    count the launch in `fused_res_stack.launches`."""
    if x.device.type == "cpu":
        return res_stack_plain(x, *weights.plain_args(), approx_snake)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, weights, approx_snake)


fused_res_stack.launches = 0
