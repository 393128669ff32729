"""Joint attention over [self | static K/V]: plain version and the wrapper
of the hand-written Hopper kernel (csrc/joint_attention.cu).

Counterpart of echo_tts_tpu/ops/pallas/joint_attention.py.  The kernel
replaces both Pallas kernels there (`_kernel`, whole-row, and
`_flash_kernel`, online softmax): one tiled online-softmax kernel serves
every shape, because the whole-row form existed only to fit the TPU's VMEM.
Its design and what bounds it on the H100 are in the source note of the
.cu file.

`fused_joint_attention` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (or raises); it never falls back.
Layouts are the JAX package's: q/k_self/v_self (GB, S, H, Dh) with the GB
axis G-major over the KV batch B, static K/V (B, T, H, Dh), the static
mask (GB, T) bool (True = attend) and an optional (T,) column scale that
multiplies the static logits (K side) and the static weights (V side).
int8 static K/V (the JAX package's opt-in KV mode) is not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

MASK_VALUE = -1e30
KERNEL_HEAD_DIM = 128   # the DiT's; the only one csrc/joint_attention.cu takes


def joint_attention_plain(q, k_self, v_self, k_static, v_static, static_mask,
                          col_scale=None, *, sm_scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, mirroring `_xla_attention`
    (joint_attention.py:366-400): fp32 logits, one softmax over
    [self | static], the column scale applied to the static weights after
    the denominator, e cast to the V dtype before PV with fp32
    accumulation.  static_mask (GB, T) bool; col_scale (T,) or None."""
    gb, s, h, dh = q.shape
    b, t = k_static.shape[:2]
    g = gb // b
    bias = torch.where(static_mask, 0.0, MASK_VALUE).float()
    scale = (torch.ones((t,), dtype=torch.float32, device=q.device)
             if col_scale is None else col_scale.float())
    qg = q.float().reshape(g, b, s, h, dh)
    ls = torch.einsum("gbshd,gbthd->gbhst", qg,
                      k_self.float().reshape(g, b, s, h, dh)) * sm_scale
    lt = torch.einsum("gbshd,bthd->gbhst", qg, k_static.float()) * sm_scale
    lt = lt * scale + bias.reshape(g, b, 1, 1, t)
    m = torch.maximum(ls.amax(-1, keepdim=True), lt.amax(-1, keepdim=True))
    e_self = torch.exp(ls - m)
    e_st = torch.exp(lt - m)
    denom = e_self.sum(-1, keepdim=True) + e_st.sum(-1, keepdim=True)
    acc = torch.einsum("gbhst,gbthd->gbhsd", e_self.to(v_self.dtype).float(),
                       v_self.float().reshape(g, b, s, h, dh))
    acc = acc + torch.einsum("gbhst,bthd->gbhsd",
                             (e_st * scale).to(v_static.dtype).float(),
                             v_static.float())
    out = (acc / denom).to(q.dtype)                  # (G, B, H, S, Dh)
    return out.permute(0, 1, 3, 2, 4).reshape(gb, s, h, dh)


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 6 + [ctypes.c_float, ctypes.c_void_p])


def _aligned(x: torch.Tensor) -> bool:
    """The kernel reads rows of 8 bf16 (16 bytes) at a time."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in x.stride()[:-1]))


def _dense(x: torch.Tensor) -> torch.Tensor:
    """x, or a contiguous 16-byte-aligned copy of it."""
    if x.is_contiguous() and _aligned(x):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _launch(q, k_self, v_self, k_static, v_static, static_mask, col_scale,
            sm_scale: float) -> torch.Tensor:
    gb, s, h, dh = q.shape
    b, t = k_static.shape[:2]
    tensors = (q, k_self, v_self, k_static, v_static)
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise TypeError("the joint-attention kernel takes bf16 q/k/v; got "
                        f"{[str(x.dtype) for x in tensors]}")
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {dh}: the kernel takes {KERNEL_HEAD_DIM}")
    dev = q.device
    extra = (static_mask,) if col_scale is None else (static_mask, col_scale)
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
    lib = cuda_build.load("joint_attention")
    fn = lib.echo_joint_attention_bf16
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(),
            k_static.data_ptr(), v_static.data_ptr(), mask.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            gb, s, h, dh, b, t, *q.stride()[:3], *k_static.stride()[:3],
            float(sm_scale), stream)
    cuda_build.check(rc, "joint_attention")
    # the temporaries made here may be freed once this returns: the caching
    # allocator hands their memory only to work queued later on this stream
    fused_joint_attention.launches += 1
    return out


def fused_joint_attention(q: torch.Tensor, k_self: torch.Tensor,
                          v_self: torch.Tensor, k_static: torch.Tensor,
                          v_static: torch.Tensor, static_mask: torch.Tensor,
                          col_scale: Optional[torch.Tensor] = None, *,
                          sm_scale: float) -> torch.Tensor:
    """Joint attention (GB, S, H, Dh) -> (GB, S, H, Dh) in q's dtype.

    CPU tensors run `joint_attention_plain`; CUDA tensors launch the kernel
    and count the launch in `fused_joint_attention.launches`."""
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
    if not k_static.is_floating_point() or not v_static.is_floating_point():
        raise TypeError("int8 static K/V is not ported yet")
    if col_scale is not None and col_scale.shape != (t,):
        raise ValueError(f"col_scale {tuple(col_scale.shape)} must be ({t},)")
    if q.device.type == "cpu":
        return joint_attention_plain(q, k_self, v_self, k_static, v_static,
                                     static_mask, col_scale, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_self, v_self, k_static, v_static, static_mask,
                   col_scale, sm_scale)


fused_joint_attention.launches = 0
