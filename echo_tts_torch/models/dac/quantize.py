"""Vector quantization for the S1-DAC codec (NLC layout).

Counterpart of echo_tts_tpu/models/dac/quantize.py (reference:
autoencoder.py:117-247): factorized, L2-normalized nearest-neighbour
lookup per codebook (VectorQuantize), stacked residually
(ResidualVectorQuantize).  The 1x1 in/out projections are weight-normed
convs, applied as matmuls.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .conv import ConvWeights


class VectorQuantize(nn.Module):
    def __init__(self, dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.in_proj = ConvWeights((codebook_dim, dim, 1), codebook_dim)
        self.out_proj = ConvWeights((dim, codebook_dim, 1), dim)
        self.codebook = nn.Embedding(codebook_size, codebook_dim)


class ResidualVectorQuantize(nn.Module):
    def __init__(self, n: int, dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.quantizers = nn.ModuleList(
            VectorQuantize(dim, codebook_size, codebook_dim) for _ in range(n))


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def _proj(p: ConvWeights, x: torch.Tensor) -> torch.Tensor:
    return x @ p.kernel()[0] + p.bias


def vq_encode(p: VectorQuantize, z: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (B, T, D) -> (z_q (B, T, D), indices (B, T)); distances between
    L2-normalized projections and codebook, z_q from the RAW codebook entry
    (autoencoder.py:130-157)."""
    z_e = _proj(p.in_proj, z)
    enc = _l2_normalize(z_e)
    cb = _l2_normalize(p.codebook.weight)
    dist = (torch.sum(enc * enc, dim=-1, keepdim=True)
            - 2.0 * enc @ cb.T
            + torch.sum(cb * cb, dim=-1)[None, None, :])
    indices = torch.argmax(-dist, dim=-1)
    z_q = _proj(p.out_proj, p.codebook.weight[indices])
    return z_q, indices


def rvq_encode(p: ResidualVectorQuantize, z: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual encode (autoencoder.py:184-221): (z_q_sum (B, T, D),
    codes (B, n_codebooks, T))."""
    residual, z_q, codes = z, torch.zeros_like(z), []
    for q in p.quantizers:
        z_q_i, idx = vq_encode(q, residual)
        residual = residual - z_q_i
        z_q = z_q + z_q_i
        codes.append(idx)
    return z_q, torch.stack(codes, dim=1)


def rvq_from_codes(p: ResidualVectorQuantize, codes: torch.Tensor) -> torch.Tensor:
    """Sum of out-projected codebook entries (autoencoder.py:223-232);
    codes (B, n_codebooks, T)."""
    b, _, t = codes.shape
    first = p.quantizers[0].out_proj
    z_q = torch.zeros((b, t, first.bias.shape[0]), dtype=first.bias.dtype,
                      device=codes.device)
    for i, q in enumerate(p.quantizers):
        z_q = z_q + _proj(q.out_proj, q.codebook.weight[codes[:, i]])
    return z_q
