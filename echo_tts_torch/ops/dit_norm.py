"""The DiT layer's fp32 norm islands: plain versions and the wrappers of
the hand-written kernel D (csrc/dit_norm.cu).

No Pallas counterpart: a port-only fusion.  Each DiT layer on each Euler
step runs two islands over its whole (GB, S, 2048) activation, which
PyTorch ran as chains of separate elementwise kernels:

  * AdaLN's normalise-and-modulate, twice a layer (`dit_adaln`; its plain
    version `dit_adaln_plain`, ops/norms.py): fp32 RMS norm, then
    `* (scale + 1) + shift` with (GB, 1, M) shift and scale in the
    conditioning dtype; the low-rank refinement of shift, scale and gate
    works on (GB, 1, M) only and stays plain (norms.adaln_conditioning);
  * the Q and K RMSNorm over each head with its (H, Dh) weight, then RoPE
    on the first n heads (`qk_norm_rope`; its plain version
    `qk_norm_rope_plain`, rms_norm then rope.rotate_first_heads): n is
    rope.rotated_heads of the layer's heads, which covers a tensor-
    parallel shard's offset.

The kernel reads each activation once in bf16 and writes it once; its
design and bound are in the source note of the .cu file.

`dit_adaln` and `qk_norm_rope` take the plain version for CPU tensors and
launch the kernel for CUDA tensors; for a CUDA tensor the kernel launches
or the call raises.  There is no switch.  Under autograd (grad mode on
and an input that requires grad: the train and distill students) the
launch runs inside `_NormKernelWithPlainGrad`, whose backward recomputes
through the plain version and differentiates it, as kernel A's
`_KernelWithPlainGrad` does: every input gets the plain version's
gradient.  The kernel reads dense rows from 16-byte-aligned bases; an
input that is not contiguous or not so aligned is refused, not copied.
Both instances count their launches in this module's `launches` (48
AdaLN and 24 Q/K launches a forward of the 24-layer DiT), exact under
CUDA-graph replay.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Tuple

import torch

from . import cuda_build
from .joint_attention import _needs_grad
from .norms import dit_adaln_plain, rms_norm
from .rope import rotate_first_heads
from ..utils import programs

KERNEL_HEAD_DIM = 128    # 16 lanes x 8 values a head row
KERNEL_MAX_MODEL = 2048  # 32 lanes x 8 chunks of 8 values a row

launches = 0


def qk_norm_rope_plain(q: torch.Tensor, k: torch.Tensor,
                       q_weight: torch.Tensor, k_weight: torch.Tensor,
                       freqs: torch.Tensor, n: int, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k (GB, S, H, Dh) RMS-normalized per head with their (H, Dh)
    weights, cast back, then rotated on their first n heads by freqs (S,
    Dh / 2, 2) fp32: the plain version of kernel D's Q/K instance."""
    return tuple(rotate_first_heads(rms_norm(x, w, eps), freqs, n)
                 for x, w in ((q, q_weight), (k, k_weight)))


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; another device
    raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def _count() -> None:
    global launches
    launches += 1


def _check_layout(what: str, **tensors) -> None:
    """The kernel reads dense rows in 16-byte chunks from 16-byte-aligned
    bases."""
    wrong = [k for k, x in tensors.items()
             if not x.is_contiguous() or x.data_ptr() % 16]
    if wrong:
        raise ValueError(f"kernel D's {what} takes contiguous tensors on "
                         f"16-byte-aligned bases; {wrong} are not")


def _check_dtypes(what: str, want: torch.dtype, **tensors) -> None:
    wrong = {k: str(x.dtype) for k, x in tensors.items() if x.dtype != want}
    if wrong:
        raise TypeError(f"kernel D's {what} takes {want}; got {wrong}")


def _check_device(*tensors: torch.Tensor) -> None:
    if any(x.device != tensors[0].device for x in tensors):
        raise ValueError("kernel D's inputs are on different devices")


_ADALN_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
_QK_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_void_p])


def _launch_adaln(x, shift, scale, eps: float) -> torch.Tensor:
    _check_dtypes("AdaLN", torch.bfloat16, x=x, shift=shift, scale=scale)
    _check_device(x, shift, scale)
    gb, s, m = x.shape
    if m % 8 or m > KERNEL_MAX_MODEL:
        raise ValueError(f"model size {m}: the kernel takes a multiple of 8 "
                         f"up to {KERNEL_MAX_MODEL}")
    _check_layout("AdaLN", x=x, shift=shift, scale=scale)
    out = torch.empty_like(x)
    fn = cuda_build.entry("dit_norm", "echo_dit_adaln", _ADALN_ARGTYPES)
    rc = fn(x.data_ptr(), shift.data_ptr(), scale.data_ptr(), out.data_ptr(),
            gb * s, s, m, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "dit_adaln")
    _count()
    return out


def _launch_qk_rope(q, k, q_weight, k_weight, freqs, n: int, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_dtypes("Q/K norm", torch.bfloat16, q=q, k=k, q_weight=q_weight,
                  k_weight=k_weight)
    _check_dtypes("RoPE table", torch.float32, freqs=freqs)
    _check_device(q, k, q_weight, k_weight, freqs)
    gb, s, h, dh = q.shape
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {dh}: the kernel takes {KERNEL_HEAD_DIM}")
    _check_layout("Q/K norm", q=q, k=k, q_weight=q_weight, k_weight=k_weight,
                  freqs=freqs)
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    fn = cuda_build.entry("dit_norm", "echo_dit_qk_rope", _QK_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), q_weight.data_ptr(),
            k_weight.data_ptr(), freqs.data_ptr(), q_out.data_ptr(),
            k_out.data_ptr(), gb, s, h, dh, n, float(eps),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(rc, "dit_qk_rope")
    _count()
    return q_out, k_out


class _NormKernelWithPlainGrad(torch.autograd.Function):
    """`launch(*tensors, *consts)` (kernel D's) in the forward; in the
    backward, `plain(*tensors, *consts)` recomputed under autograd and
    differentiated, so that each tensor gets the plain version's
    gradient."""

    @staticmethod
    def forward(ctx, launch, plain, consts, *tensors):
        ctx.plain, ctx.consts = plain, consts
        ctx.save_for_backward(*tensors)
        return launch(*tensors, *consts)

    @staticmethod
    def backward(ctx, *grad_outs):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            args = [x.detach().requires_grad_() if need else x
                    for x, need in zip(ctx.saved_tensors, needs)]
            outs = ctx.plain(*args, *ctx.consts)
            grads = iter(torch.autograd.grad(
                outs, [a for a, need in zip(args, needs) if need], grad_outs))
        return (None, None, None,
                *(next(grads) if need else None for need in needs))


def dit_adaln(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    """x (GB, S, M) RMS-normalized in fp32 and modulated by shift and scale
    (GB, 1, M), in x's dtype: kernel D for CUDA tensors (bf16; under
    autograd with the plain version's gradient), `dit_adaln_plain` for
    CPU tensors."""
    if x.dim() != 3 or shift.shape != (x.shape[0], 1, x.shape[2]) \
            or scale.shape != shift.shape:
        raise ValueError(f"x {tuple(x.shape)} must be (GB, S, M) and shift "
                         f"{tuple(shift.shape)}, scale {tuple(scale.shape)} "
                         "(GB, 1, M)")
    if not _on_card(x):
        return dit_adaln_plain(x, shift, scale, eps)
    if _needs_grad(x, shift, scale):
        return _NormKernelWithPlainGrad.apply(
            _launch_adaln, dit_adaln_plain, (eps,), x, shift, scale)
    return _launch_adaln(x, shift, scale, eps)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, q_weight: torch.Tensor,
                 k_weight: torch.Tensor, freqs: torch.Tensor, n: int,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k (GB, S, H, Dh) normalized per head with their (H, Dh)
    weights and rotated on their first n heads by freqs (S, Dh / 2, 2)
    fp32: kernel D for CUDA tensors (bf16, Dh = 128; under autograd with
    the plain version's gradient), `qk_norm_rope_plain` for CPU
    tensors."""
    gb, s, h, dh = q.shape
    if (k.shape != q.shape or q_weight.shape != (h, dh)
            or k_weight.shape != (h, dh) or freqs.shape != (s, dh // 2, 2)
            or dh % 2 or not 0 <= n <= h):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must be "
                         f"(GB, S, H, Dh), the weights "
                         f"{tuple(q_weight.shape)}, {tuple(k_weight.shape)} "
                         f"(H, Dh), freqs {tuple(freqs.shape)} (S, Dh / 2, 2) "
                         f"and 0 <= n = {n} <= H")
    if not _on_card(q):
        return qk_norm_rope_plain(q, k, q_weight, k_weight, freqs, n, eps)
    if _needs_grad(q, k, q_weight, k_weight, freqs):
        return _NormKernelWithPlainGrad.apply(
            _launch_qk_rope, qk_norm_rope_plain, (n, eps), q, k, q_weight,
            k_weight, freqs)
    return _launch_qk_rope(q, k, q_weight, k_weight, freqs, n, eps)


# exact under CUDA-graph replay (utils/programs.py)
programs.register_counters(sys.modules[__name__], "launches")
