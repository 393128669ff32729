"""Window-limited causal transformer inside the S1-DAC quantizer and
encoder (reference: autoencoder.py:503-826).

Counterpart of echo_tts_tpu/models/dac/transformer.py.  Parity details:
  * the RoPE cos/sin table is rounded to bfloat16 at build time even in an
    fp32 model (autoencoder.py:805-813), then applied in fp32;
  * RMSNorm casts back to the input dtype BEFORE the weight multiply
    (autoencoder.py:726-731);
  * fused QKV, softmax over a window-limited causal mask (key j visible to
    query i iff i-W < j <= i), LayerScale residuals.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config import AETransformerConfig


class _Norm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-2))


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.wqkv = nn.Linear(dim, 3 * dim, bias=False)
        self.wo = nn.Linear(dim, dim, bias=False)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, inter: int):
        super().__init__()
        self.w1 = nn.Linear(dim, inter, bias=False)
        self.w3 = nn.Linear(dim, inter, bias=False)
        self.w2 = nn.Linear(inter, dim, bias=False)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: AETransformerConfig):
        super().__init__()
        self.attention = _Attention(cfg.dim)
        self.feed_forward = _FeedForward(cfg.dim, cfg.intermediate_size)
        self.attention_norm = _Norm(cfg.dim)
        self.ffn_norm = _Norm(cfg.dim)
        self.attention_layer_scale = _LayerScale(cfg.dim)
        self.ffn_layer_scale = _LayerScale(cfg.dim)


class WindowLimitedTransformer(nn.Module):
    def __init__(self, cfg: AETransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(TransformerBlock(cfg)
                                    for _ in range(cfg.n_layer))
        self.norm = _Norm(cfg.dim)


@functools.lru_cache(maxsize=16)
def _rope_table_bf16(seq_len: int, n_elem: int, base: float) -> np.ndarray:
    """(S, n_elem//2, 2) cos/sin, rounded to bf16, returned as float32."""
    freqs = 1.0 / (base ** (np.arange(0, n_elem, 2)[: n_elem // 2]
                            .astype(np.float32) / n_elem))
    t = np.arange(seq_len, dtype=np.float32)
    angles = np.outer(t, freqs).astype(np.float32)
    table = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    return torch.from_numpy(table).to(torch.bfloat16).float().numpy()


def _apply_rope(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs, fp32 (autoencoder.py:815-826)."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    cos = table[None, :, None, :, 0]
    sin = table[None, :, None, :, 1]
    out = torch.stack([xf[..., 0] * cos - xf[..., 1] * sin,
                       xf[..., 1] * cos + xf[..., 0] * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _rms_norm_ae(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return xf.to(x.dtype) * weight


def window_causal_mask(length: int, window, device=None) -> torch.Tensor:
    """(S, S) bool; True = attend (autoencoder.py:762-784)."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    mask = j <= i
    if window is not None:
        mask &= j >= torch.clamp(i - window + 1, min=0)
    return mask


def transformer_forward(p: WindowLimitedTransformer, cfg: AETransformerConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """WindowLimitedTransformer.forward over NLC input
    (autoencoder.py:786-802, 590-608)."""
    b, s, d = x.shape
    h, hd = cfg.n_head, cfg.head_dim
    table = torch.from_numpy(_rope_table_bf16(s, hd, cfg.rope_base)).to(x.device)
    keep = window_causal_mask(s, cfg.window_size, x.device)[None, None]
    scale = 1.0 / (hd ** 0.5)
    for blk in p.layers:
        xn = _rms_norm_ae(x, blk.attention_norm.weight, cfg.norm_eps)
        q, k, v = torch.chunk(blk.attention.wqkv(xn), 3, dim=-1)
        q = _apply_rope(q.reshape(b, s, h, hd), table)
        k = _apply_rope(k.reshape(b, s, h, hd), table)
        v = v.reshape(b, s, h, hd)
        logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
        logits = logits.masked_fill(~keep, float("-inf"))
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.einsum("bhst,bthd->bshd", w, v).reshape(b, s, d)
        x = x + blk.attention_layer_scale.gamma * blk.attention.wo(attn)
        xn = _rms_norm_ae(x, blk.ffn_norm.weight, cfg.norm_eps)
        ff = blk.feed_forward
        x = x + blk.ffn_layer_scale.gamma * ff.w2(F.silu(ff.w1(xn)) * ff.w3(xn))
    return _rms_norm_ae(x, p.norm.weight, cfg.norm_eps)
