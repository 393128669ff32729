"""RMSNorm and low-rank AdaLN with the reference's fp32-island casts.

Counterpart of echo_tts_tpu/ops/norms.py (reference: model.py:46-104):
upcast to float32, normalize, multiply/modulate, cast back.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 RMS norm over the last axis; weight may be (D,) or (H, D)."""
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(dtype)


class LowRankAdaLN(nn.Module):
    """Low-rank AdaLN parameters (reference: model.py:46-83): per
    shift/scale/gate a down projection (M -> R, no bias) and an up
    projection (R -> M, with bias)."""

    def __init__(self, model_size: int, rank: int):
        super().__init__()
        for name in ("shift", "scale", "gate"):
            setattr(self, f"{name}_down", nn.Linear(model_size, rank, bias=False))
            setattr(self, f"{name}_up", nn.Linear(rank, model_size, bias=True))


def low_rank_adaln(x: torch.Tensor, cond_embed: torch.Tensor,
                   p: LowRankAdaLN, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cond_embed (B, 1, 3M) is chunked into (shift, scale, gate), each
    refined by `up(down(silu(c))) + c`; x is RMS-normalized in fp32,
    modulated `x * (scale + 1) + shift` and cast back; gate goes through
    tanh in the conditioning dtype."""
    shift, scale, gate = torch.chunk(cond_embed, 3, dim=-1)

    def refine(c, down, up):
        return up(down(F.silu(c))) + c

    shift = refine(shift, p.shift_down, p.shift_up)
    scale = refine(scale, p.scale_down, p.scale_up)
    gate = refine(gate, p.gate_down, p.gate_up)

    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    # (scale + 1) rounds in the conditioning dtype before promotion to fp32
    xf = xf * (scale + 1) + shift
    return xf.to(dtype), torch.tanh(gate)
