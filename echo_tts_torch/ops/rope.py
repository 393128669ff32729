"""Rotary position embeddings (cos/sin table, interleaved pairs).

Counterpart of echo_tts_tpu/ops/rope.py: full RoPE over interleaved
(even, odd) pairs (reference: model.py:9-24) and the half-the-heads variant
of the DiT joint attention (reference: model.py:199-202).  Rotations are
computed in float32 and cast back to the input dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0) -> np.ndarray:
    """(end, dim//2, 2) float32 numpy table; entry [t, j] is
    (cos(t * theta^(-2j/dim)), sin(...))."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float32) / dim))
    t = np.arange(end, dtype=np.float32)
    angles = np.outer(t, freqs).astype(np.float32)
    table = np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=64)
def _freqs_on(dim: int, end: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(precompute_freqs_cis(dim, end).copy()).to(device)


def freqs_tensor(dim: int, end: int, device) -> torch.Tensor:
    """The table on `device`, cached so the sampler's steps copy nothing
    from the host."""
    return _freqs_on(dim, end, torch.device(device))


def apply_rotary_emb(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of the last dim of x (B, S, H, D);
    freqs_cis (S, D//2, 2) float32 broadcasts over batch and heads."""
    dtype = x.dtype
    xr = x.float().reshape(*x.shape[:-1], -1, 2)
    x_even, x_odd = xr[..., 0], xr[..., 1]
    cos = freqs_cis[..., 0][:, None, :]  # (S, 1, D//2)
    sin = freqs_cis[..., 1][:, None, :]
    out_even = x_even * cos - x_odd * sin
    out_odd = x_odd * cos + x_even * sin
    return torch.stack([out_even, out_odd], dim=-1).reshape(x.shape).to(dtype)


def apply_rotary_emb_half_heads(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """RoPE on the first half of the HEADS only (model.py:199-202)."""
    h = x.shape[-2]
    x1, x2 = x[..., : h // 2, :], x[..., h // 2:, :]
    return torch.cat([apply_rotary_emb(x1, freqs_cis), x2], dim=-2)
