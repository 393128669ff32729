"""W8A8 matmul with dynamic per-row activation quantization: plain version
and the wrapper of the hand-written Hopper kernel (csrc/int8_matmul.cu,
kernel C).

Counterpart of echo_tts_tpu/ops/pallas/int8_matmul.py.  There the Pallas
kernel is a kept experiment that the JAX package's `int8_dot` does not
call (XLA pipelined the quantize-dot-rescale better on the TPU); the two
compute one function, so here `ops.quant.int8_dot` launches this kernel
for CUDA tensors.  What bounds the kernel on the H100 is in the source
note of the .cu file: a pre-pass quantizes x once (`quantize_last` is its
plain version), then a TMA-fed wgmma product rescales the int32 sums;
`_tile_plan` picks its output tile.

Layouts are the port's nn.Linear ones: x (..., K), w8 (N, K) int8 (row n
is output channel n; the JAX package stores (K, N)), w_scale (N,) fp32.
`int8_matmul_fused` checks the shape on every device, takes the plain
version for CPU tensors and launches the kernel for CUDA tensors (or
raises); it never falls back.  One call counts one launch, though the card
runs the pre-pass and the product.

`int8_matmul_partial` is kernel C's row-parallel instance, for a K-slice
of a tensor-parallel layer (parallel/mesh.py `row_parallel`): the row
scale is given (taken over the whole K), and the int32 sums come out
unscaled, to be summed over the slices and rescaled once (`int8_rescale`),
which gives the unsharded product exactly.  Its plain version is
`int8_matmul_partial_plain`; its launches count in
`int8_matmul_partial.launches`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import cuda_build


def quantize_last(a: torch.Tensor, qmax: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization over the last axis: (round(a / scale) clipped
    to [-qmax, qmax], as fp32; scale = max(abs-max, 1e-12) / qmax, fp32
    (...,)).  Both divisions are IEEE divisions on every device: PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, which
    can be one ulp off, so the divisor is a tensor."""
    af = a.float()
    amax = af.abs().amax(-1)
    scale = amax.clamp_min(1e-12) / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(af / scale[..., None]), -qmax, qmax)
    return q, scale


def int8_matmul_plain(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX package's
    ops/quant.py:65-83): per-row abs-max over all of K, x_scale =
    max(amax, 1e-12) / 127, xq = clip(round(x / x_scale), -127, 127),
    acc = xq @ w8^T, out = f32(acc) * x_scale * w_scale in that order.
    The product accumulates in float64, which is exact for any |acc| <
    2^53 on the CPU and the card alike (PyTorch's only integer matmul on
    CUDA is a library kernel)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xq, x_scale = quantize_last(x, 127.0)
    acc = xq.double() @ w8.double().t()
    return (acc.float() * x_scale[..., None] * w_scale.float()).to(out_dtype)


def int8_matmul_partial_plain(x: torch.Tensor, w8: torch.Tensor,
                              x_scale: torch.Tensor) -> torch.Tensor:
    """The row-parallel instance's function: x (..., K) quantized with the
    given row scales x_scale (...,) fp32 (clip(round(x / x_scale)), the
    same IEEE division as `quantize_last`), then xq @ w8^T as int32 sums,
    (..., N), exact (float64 accumulation, as `int8_matmul_plain`)."""
    xq = torch.clamp(torch.round(x.float() / x_scale.float()[..., None]),
                     -127.0, 127.0)
    return (xq.double() @ w8.double().t()).to(torch.int32)


def int8_rescale(acc: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """f32(acc) * x_scale * w_scale in that order, in out_dtype: the
    epilogue of kernel C (and of `int8_matmul_plain`)."""
    return (acc.float() * x_scale.float()[..., None]
            * w_scale.float()).to(out_dtype)


def supported(m: int, k: int, n: int) -> bool:
    """Shapes kernel C takes: any number of rows, K a multiple of 16 (16-byte
    rows of int8 for TMA) and N a multiple of 8 (the epilogue stores
    column pairs and masks whole groups of 8).  The DiT's
    shapes all qualify (K, N in {64, 96} tiny; 2048, 5888 full width)."""
    return m >= 1 and k >= 16 and k % 16 == 0 and n >= 8 and n % 8 == 0


TILE_M = 128     # output rows per block: two consumer warpgroups


def _tile_plan(m: int, k: int, n: int) -> Tuple[int, int]:
    """(rows, columns) of kernel C's output tile, one block each: 128 x 256
    (which reads less from L2 per product) where that still gives at least
    half as many blocks as SMs, else 128 x 128.  Why some main-path shapes
    get fewer blocks than SMs is in the source note of csrc/int8_matmul.cu.
    K is never split, so each output element is one block's int32 sum."""
    wide = math.ceil(m / TILE_M) * math.ceil(n / 256) >= cuda_build.SMS // 2
    return TILE_M, 256 if wide else 128


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x as a contiguous tensor whose data starts on 16 bytes."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(x2d: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    if x2d.dtype != torch.bfloat16:
        raise TypeError(f"the int8 matmul kernel takes bf16 x; got {x2d.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the int8 matmul kernel writes bf16 or fp32; got "
                        f"{out_dtype}")
    dev = x2d.device
    if w8.device != dev or w_scale.device != dev:
        raise ValueError("int8 matmul inputs on different devices")
    (m, k), n = x2d.shape, w8.shape[0]
    x2d, w8 = _aligned(x2d), _aligned(w8)
    w_scale = w_scale.float().contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    # the pre-pass's output in one scratch buffer (one allocation less per
    # call): x quantized once, (m, k) int8, then its (m,) fp32 row scales
    # from the next 16-byte boundary
    off = -(-m * k // 16) * 16
    scratch = torch.empty((off + 4 * m,), dtype=torch.int8, device=dev)
    fn = cuda_build.entry("int8_matmul", "echo_int8_matmul", _ARGTYPES)
    rc = fn(x2d.data_ptr(), w8.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + off, m, n, k,
            int(out_dtype == torch.bfloat16), _tile_plan(m, k, n)[1],
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "int8_matmul")
    int8_matmul_fused.launches += 1
    return out


def int8_matmul_fused(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ dequant(w8)^T with in-kernel dynamic activation quantization,
    (..., K) -> (..., N) in out_dtype (default x's dtype).  Leading axes of
    x are flattened into rows.

    Raises on a shape `supported()` refuses, on every device.  CPU tensors
    run `int8_matmul_plain`; CUDA tensors launch kernel C and count the
    launch in `int8_matmul_fused.launches`.  Raises, on every device, when
    grad mode is on and x or w_scale requires grad: the kernel has no
    backward."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    k = x.shape[-1]
    if w8.dtype != torch.int8 or w8.ndim != 2 or w8.shape[1] != k:
        raise ValueError(f"w8 must be int8 (N, {k}); got {w8.dtype} "
                         f"{tuple(w8.shape)}")
    n = w8.shape[0]
    if w_scale.shape != (n,):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} must be ({n},)")
    m = x.numel() // k if k else 0
    if not supported(m, k, n):
        raise ValueError(f"unsupported W8A8 kernel shape m={m} k={k} n={n}")
    if torch.is_grad_enabled() and (x.requires_grad or w_scale.requires_grad):
        raise RuntimeError(
            "the W8A8 matmul has no gradient (the JAX package never "
            "differentiates it); call it under torch.no_grad() or "
            "torch.inference_mode(), or on tensors that do not require grad")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w8, w_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x.reshape(m, k), w8, w_scale, out_dtype)
    return out.reshape(*x.shape[:-1], n)


int8_matmul_fused.launches = 0


_ARGTYPES_PARTIAL = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])


def _launch_partial(x2d: torch.Tensor, w8: torch.Tensor,
                    x_scale: torch.Tensor) -> torch.Tensor:
    if x2d.dtype != torch.bfloat16:
        raise TypeError(f"the int8 matmul kernel takes bf16 x; got {x2d.dtype}")
    dev = x2d.device
    if w8.device != dev or x_scale.device != dev:
        raise ValueError("int8 matmul inputs on different devices")
    (m, k), n = x2d.shape, w8.shape[0]
    x2d, w8 = _aligned(x2d), _aligned(w8)
    x_scale = x_scale.float().contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    fn = cuda_build.entry("int8_matmul", "echo_int8_matmul_partial",
                          _ARGTYPES_PARTIAL)
    rc = fn(x2d.data_ptr(), w8.data_ptr(), x_scale.data_ptr(), out.data_ptr(),
            xq.data_ptr(), m, n, k, _tile_plan(m, k, n)[1],
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "int8_matmul_partial")
    int8_matmul_partial.launches += 1
    return out


def int8_matmul_partial(x: torch.Tensor, w8: torch.Tensor,
                        x_scale: torch.Tensor) -> torch.Tensor:
    """The row-parallel instance of kernel C: x (..., K) bf16 quantized
    with the given row scales x_scale (...,) fp32, times w8 (N, K) int8,
    as int32 sums (..., N), not rescaled.  Shapes as int8_matmul_fused
    takes them; CPU tensors run `int8_matmul_partial_plain`, CUDA tensors
    launch the kernel and count it in `int8_matmul_partial.launches`.  No
    gradient."""
    k = x.shape[-1]
    if w8.dtype != torch.int8 or w8.ndim != 2 or w8.shape[1] != k:
        raise ValueError(f"w8 must be int8 (N, {k}); got {w8.dtype} "
                         f"{tuple(w8.shape)}")
    n = w8.shape[0]
    if x_scale.shape != x.shape[:-1]:
        raise ValueError(f"x_scale {tuple(x_scale.shape)} must be "
                         f"{tuple(x.shape[:-1])}")
    m = x.numel() // k if k else 0
    if not supported(m, k, n):
        raise ValueError(f"unsupported W8A8 kernel shape m={m} k={k} n={n}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the W8A8 matmul has no gradient; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.device.type == "cpu":
        return int8_matmul_partial_plain(x, w8, x_scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch_partial(x.reshape(m, k), w8, x_scale.reshape(m))
    return out.reshape(*x.shape[:-1], n)


int8_matmul_partial.launches = 0
