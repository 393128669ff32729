"""Scaled dot-product attention for the encoders.

Counterpart of echo_tts_tpu/ops/attention.py: boolean masks (True =
attend), fp32 logits and softmax, 1/sqrt(head_dim) scaling (reference
usage: model.py:148-154, autoencoder.py:698-702).  The JAX package runs
this outside any Pallas kernel, so it stays plain PyTorch here.
"""
from __future__ import annotations

from typing import Optional

import torch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None,
         is_causal: bool = False) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, H, D); mask broadcastable to
    (B, H, S, T).  Returns (B, S, H, D) in v.dtype."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if is_causal:
        s, t = q.shape[1], k.shape[1]
        causal = torch.ones((s, t), dtype=torch.bool,
                            device=q.device).tril(diagonal=t - s)
        logits = logits.masked_fill(~causal[None, None], float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", weights, v)
