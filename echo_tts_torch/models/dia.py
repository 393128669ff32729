"""Dia (Nari Labs), the encoder-decoder text-to-speech model that generates
Descript DAC codes frame by frame, on the port's serving path.

Written from the public dia/layers.py and dia/model.py
(github.com/nari-labs/dia) at the widths of config.json
(huggingface.co/nari-labs/Dia-1.6B), config.DiaConfig:

  * a text encoder over bytes (embedding, `encoder_n_layer` pre-norm
    layers of self-attention and a gated MLP, a final norm), where valid
    positions attend to valid ones and pad positions to pad ones;
  * a decoder over the sum of the `channels` codebook embeddings of each
    frame: pre-norm layers of causal GQA self-attention (its K/V in a
    preallocated cache), cross-attention to the encoded text (its K/V
    computed once a request), the gated MLP, a final norm and the logits
    head (decoder width -> channels x tgt_vocab_size, fp32).

The equations: RMSNorm in fp32 then cast (eps
normalization_layer_epsilon); the MLP wo(silu(x W_gate) * x W_up) with
gate and up fused in `wi_fused` (gate first); RoPE over the whole head in
the split-halves form, timescales rope_min_timescale .. rope_max_timescale,
on q and k in self-attention and, in cross-attention, on q at the
decoder's positions and on the cached k at the encoder's; attention logits
unscaled (layers.py passes scale=1.0).  Linear weights are nn.Linear's
(out, in), the published DenseGeneral kernels flattened and transposed.

The decoder runs in two forms over one cache (sampler/ar.py drives them):
`prefill`, a causal pass over a block of frames that writes their K/V,
and `decode_step`, one frame a row at each row's own position, which
writes its K/V at that position and attends to the cache up to it, read
over the first `attn_len` positions (a length bucket; the mask keeps the
row's own).  The cross K/V lives in the same state (`cross_kv`).

`DiaModels` is the serving bundle: the model, Descript's DAC 44 kHz
(models/dac/dac.py DAC44) and the compute dtype.  `random_dia_models`
gives seeded random weights; the published-weight loader waits until
Dia's and DAC's safetensors are in the repository.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DACConfig, DiaConfig, dac44k_config
from ..ops.norms import rms_norm
from .dac.dac import DAC44


# ---------------------------------------------------------------------------
# Modules (named after dia/layers.py's)
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    def __init__(self, q_dim: int, kv_dim: int, heads: int, kv_heads: int,
                 head_dim: int):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, head_dim
        self.q_proj = nn.Linear(q_dim, heads * head_dim, bias=False)
        self.k_proj = nn.Linear(kv_dim, kv_heads * head_dim, bias=False)
        self.v_proj = nn.Linear(kv_dim, kv_heads * head_dim, bias=False)
        self.o_proj = nn.Linear(heads * head_dim, q_dim, bias=False)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.wi_fused = nn.Linear(dim, 2 * hidden, bias=False)
        self.wo = nn.Linear(hidden, dim, bias=False)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        d = cfg.encoder_n_embd
        self.pre_sa_norm = RMSNorm(d)
        self.self_attention = Attention(d, d, cfg.encoder_n_head,
                                        cfg.encoder_n_head,
                                        cfg.encoder_head_dim)
        self.post_sa_norm = RMSNorm(d)
        self.mlp = MlpBlock(d, cfg.encoder_n_hidden)


class Encoder(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        self.embedding = nn.Embedding(cfg.src_vocab_size, cfg.encoder_n_embd)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.encoder_n_layer))
        self.norm = RMSNorm(cfg.encoder_n_embd)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        d = cfg.decoder_n_embd
        self.pre_sa_norm = RMSNorm(d)
        self.self_attention = Attention(d, d, cfg.gqa_query_heads,
                                        cfg.kv_heads, cfg.gqa_head_dim)
        self.pre_ca_norm = RMSNorm(d)
        self.cross_attention = Attention(d, cfg.encoder_n_embd,
                                         cfg.cross_query_heads,
                                         cfg.cross_query_heads,
                                         cfg.cross_head_dim)
        self.pre_mlp_norm = RMSNorm(d)
        self.mlp = MlpBlock(d, cfg.decoder_n_hidden)


class Decoder(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        d = cfg.decoder_n_embd
        self.embeddings = nn.ModuleList(
            nn.Embedding(cfg.tgt_vocab_size, d) for _ in range(cfg.channels))
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.decoder_n_layer))
        self.norm = RMSNorm(d)
        self.logits_dense = nn.Linear(d, cfg.channels * cfg.tgt_vocab_size,
                                      bias=False)


class DiaModel(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

def _norm(m: RMSNorm, x: torch.Tensor, cfg: DiaConfig) -> torch.Tensor:
    return rms_norm(x, m.weight, cfg.normalization_layer_epsilon)


def _mlp(m: MlpBlock, x: torch.Tensor) -> torch.Tensor:
    gate, up = m.wi_fused(x).split(m.hidden, dim=-1)
    return m.wo(F.silu(gate) * up)


def timescale(cfg: DiaConfig, head_dim: int, device) -> torch.Tensor:
    """RotaryEmbedding's timescales (head_dim / 2,) fp32 (layers.py)."""
    frac = 2.0 * torch.arange(head_dim // 2, device=device,
                              dtype=torch.float32) / head_dim
    lo, hi = cfg.rope_min_timescale, cfg.rope_max_timescale
    return lo * (hi / lo) ** frac


def rope(x: torch.Tensor, positions: torch.Tensor,
         scales: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) rotated in fp32 in the split-halves form and cast
    back; positions broadcast against (..., S)."""
    ang = positions.float()[..., None, None] / scales
    sin, cos = torch.sin(ang), torch.cos(ang)
    a, b = x.float().chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """x (..., hd) rotated by tables (..., hd / 2) fp32 that broadcast
    against it, in fp32, cast back: `rope` with the tables made once."""
    a, b = x.float().chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(R, S, heads * hd) -> (R, S, heads, hd)."""
    return x.view(*x.shape[:-1], heads, -1)


def _sdpa(q, k, v, mask=None, causal=False, gqa=False):
    """Attention with the published scale of 1 (layers.py); q (R, H, Sq,
    hd), k and v (R, Hkv, Sk, hd); `mask` bool, True where attended."""
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, scale=1.0,
        enable_gqa=gqa)


# ---------------------------------------------------------------------------
# Encoder and cross K/V
# ---------------------------------------------------------------------------

def encode(model: DiaModel, ids: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """Text bytes ids (R, T) and valid (R, T) bool -> (R, T, encoder width),
    after the final norm.  Valid positions attend to valid ones, pad
    positions to pad ones (dia/model.py create_attn_mask); positions
    0 .. T - 1."""
    cfg, enc = model.cfg, model.encoder
    x = enc.embedding(ids)
    mask = (valid[:, :, None] == valid[:, None, :])[:, None]
    pos = torch.arange(ids.shape[1], device=ids.device)
    scales = timescale(cfg, cfg.encoder_head_dim, ids.device)
    for layer in enc.layers:
        a = layer.self_attention
        h = _norm(layer.pre_sa_norm, x, cfg)
        q = rope(_heads(a.q_proj(h), a.heads), pos, scales)
        k = rope(_heads(a.k_proj(h), a.kv_heads), pos, scales)
        v = _heads(a.v_proj(h), a.kv_heads)
        o = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  mask)
        x = x + a.o_proj(o.transpose(1, 2).flatten(2))
        x = x + _mlp(layer.mlp, _norm(layer.post_sa_norm, x, cfg))
    return _norm(enc.norm, x, cfg)


def cross_kv(model: DiaModel, enc_out: torch.Tensor, k_out: torch.Tensor,
             v_out: torch.Tensor) -> None:
    """Every decoder layer's cross-attention K (RoPE at the encoder's
    positions) and V of enc_out (R, T, D_enc), written into k_out and
    v_out (layers, R, heads, T, hd) (Decoder.precompute_cross_attn_cache)."""
    cfg = model.cfg
    pos = torch.arange(enc_out.shape[1], device=enc_out.device)
    scales = timescale(cfg, cfg.cross_head_dim, enc_out.device)
    for i, layer in enumerate(model.decoder.layers):
        a = layer.cross_attention
        k = rope(_heads(a.k_proj(enc_out), a.kv_heads), pos, scales)
        k_out[i].copy_(k.transpose(1, 2))
        v_out[i].copy_(_heads(a.v_proj(enc_out), a.kv_heads).transpose(1, 2))


# ---------------------------------------------------------------------------
# Decoder: prefill and one step through the cache
# ---------------------------------------------------------------------------

def embed(model: DiaModel, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (..., channels) -> the sum of the channels' embeddings."""
    embs = model.decoder.embeddings
    x = embs[0](tokens[..., 0])
    for c in range(1, len(embs)):
        x = x + embs[c](tokens[..., c])
    return x


def logits(model: DiaModel, h: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden states (..., D) -> logits (..., channels, vocab)
    fp32 (the head in the compute dtype, then cast, as published)."""
    cfg = model.cfg
    out = model.decoder.logits_dense(h).float()
    return out.view(*h.shape[:-1], cfg.channels, cfg.tgt_vocab_size)


def prefill(model: DiaModel, tokens: torch.Tensor, k_self: torch.Tensor,
            v_self: torch.Tensor, k_cross: torch.Tensor,
            v_cross: torch.Tensor, text_valid: torch.Tensor) -> torch.Tensor:
    """The causal pass over frames 0 .. S - 1 of every row: tokens (R, S,
    channels) -> final-normed hidden states (R, S, D); writes the frames'
    self K/V into k_self / v_self (layers, R, kv_heads, capacity, hd) at
    positions 0 .. S - 1.  Cross-attention reads k_cross / v_cross under
    text_valid (R, T)."""
    cfg, dec = model.cfg, model.decoder
    s = tokens.shape[1]
    x = embed(model, tokens)
    pos = torch.arange(s, device=tokens.device)
    sc_self = timescale(cfg, cfg.gqa_head_dim, tokens.device)
    sc_cross = timescale(cfg, cfg.cross_head_dim, tokens.device)
    cmask = text_valid[:, None, None, :]
    for i, layer in enumerate(dec.layers):
        a = layer.self_attention
        h = _norm(layer.pre_sa_norm, x, cfg)
        q = rope(_heads(a.q_proj(h), a.heads), pos, sc_self).transpose(1, 2)
        k = rope(_heads(a.k_proj(h), a.kv_heads), pos, sc_self).transpose(1, 2)
        v = _heads(a.v_proj(h), a.kv_heads).transpose(1, 2)
        k_self[i, :, :, :s].copy_(k)
        v_self[i, :, :, :s].copy_(v)
        o = _sdpa(q, k, v, causal=True, gqa=a.heads != a.kv_heads)
        x = x + a.o_proj(o.transpose(1, 2).flatten(2))
        c = layer.cross_attention
        h = _norm(layer.pre_ca_norm, x, cfg)
        q = rope(_heads(c.q_proj(h), c.heads), pos, sc_cross).transpose(1, 2)
        o = _sdpa(q, k_cross[i], v_cross[i], cmask)
        x = x + c.o_proj(o.transpose(1, 2).flatten(2))
        x = x + _mlp(layer.mlp, _norm(layer.pre_mlp_norm, x, cfg))
    return _norm(dec.norm, x, cfg)


def decode_step(model: DiaModel, x: torch.Tensor, pos: torch.Tensor,
                k_self: torch.Tensor, v_self: torch.Tensor,
                k_cross: torch.Tensor, v_cross: torch.Tensor,
                text_valid: torch.Tensor, attn_len: int) -> torch.Tensor:
    """One frame a row: x (R, D) embedded at positions pos (R,) long ->
    logits (R, channels, vocab) fp32.  Each layer writes the row's K/V at
    its position and attends over cache positions 0 .. attn_len - 1 with
    those past the row's own masked (attn_len >= max(pos) + 1).  GQA runs
    as each K/V head's query heads taken as its query positions, so that
    the cache is read once a K/V head."""
    cfg, dec = model.cfg, model.decoder
    r = x.shape[0]
    rows = torch.arange(r, device=x.device)
    # the rows' rotation tables, made once for every layer: (r, 1, hd / 2)
    tables = {}
    for hd in {cfg.gqa_head_dim, cfg.cross_head_dim}:
        ang = pos.float()[:, None, None] / timescale(cfg, hd, x.device)
        tables[hd] = (torch.cos(ang), torch.sin(ang))
    keep = (torch.arange(attn_len, device=x.device)[None] <= pos[:, None])
    smask = keep[:, None, None, :]
    cmask = text_valid[:, None, None, :]
    x = x[:, None]
    for i, layer in enumerate(dec.layers):
        a = layer.self_attention
        h = _norm(layer.pre_sa_norm, x, cfg)[:, 0]
        q = _rotate(_heads(a.q_proj(h), a.heads), *tables[cfg.gqa_head_dim])
        k = _rotate(_heads(a.k_proj(h), a.kv_heads),
                    *tables[cfg.gqa_head_dim])
        v = _heads(a.v_proj(h), a.kv_heads)
        k_self[i, rows, :, pos] = k
        v_self[i, rows, :, pos] = v
        g = a.heads // a.kv_heads
        o = _sdpa(q.view(r, a.kv_heads, g, -1), k_self[i, :, :, :attn_len],
                  v_self[i, :, :, :attn_len], smask)
        x = x + a.o_proj(o.reshape(r, 1, -1))
        c = layer.cross_attention
        h = _norm(layer.pre_ca_norm, x, cfg)[:, 0]
        q = _rotate(_heads(c.q_proj(h), c.heads), *tables[cfg.cross_head_dim])
        o = _sdpa(q[:, :, None], k_cross[i], v_cross[i], cmask)
        x = x + c.o_proj(o.reshape(r, 1, -1))
        x = x + _mlp(layer.mlp, _norm(layer.pre_mlp_norm, x, cfg))
    return logits(model, _norm(dec.norm, x[:, 0], cfg))


# ---------------------------------------------------------------------------
# The serving bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DiaModels:
    """Dia, the codec it decodes with, and the compute dtype.
    `keep_logits` is how many requests of a pass may ask for their logits
    (BatchRequest.keep_logits), the slots of the frame loop's record."""
    dia: DiaModel
    dac: DAC44
    dtype: torch.dtype = torch.bfloat16
    keep_logits: int = 0

    @property
    def cfg(self) -> DiaConfig:
        return self.dia.cfg

    @property
    def dac_cfg(self) -> DACConfig:
        return self.dac.cfg

    @property
    def device(self) -> torch.device:
        return next(self.dia.parameters()).device


def query_std(fan_in: int, head_dim: int) -> float:
    """The q projections' draw, N(0, 1 / (fan_in * head_dim)): with the
    unscaled logits of layers.py this keeps them O(1) under random
    weights, as the trained model's are."""
    return (fan_in * head_dim) ** -0.5


@torch.no_grad()
def init_dia_(model: DiaModel, seed: int) -> DiaModel:
    """Seeded random weights, drawn where the parameters lie: linears
    N(0, 1 / fan_in) but the q projections (query_std), embeddings
    N(0, 1), norms 1."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
            continue
        std = 1.0
        if p.ndim == 2 and "embedding" not in name:
            std = p.shape[1] ** -0.5
            if name.endswith("q_proj.weight"):
                head_dim = (model.cfg.encoder_head_dim
                            if name.startswith("encoder") else
                            model.cfg.cross_head_dim if "cross" in name
                            else model.cfg.gqa_head_dim)
                std = query_std(p.shape[1], head_dim)
        p.copy_(torch.randn(p.shape, generator=gen, device=device,
                            dtype=p.dtype) * std)
    return model


def random_dia_models(device="cuda", dtype=torch.bfloat16, seed: int = 0, *,
                      cfg: Optional[DiaConfig] = None,
                      dac_cfg: Optional[DACConfig] = None,
                      keep_logits: int = 0) -> DiaModels:
    """Dia and DAC 44 kHz with seeded random weights (the codec's as
    models/dac/init.py draws S1-DAC's), the model in `dtype`, the codec
    bf16 with the decoder's polynomial snake on the card and fp32 with
    exact sin on the CPU, the serving setting of the Echo bundle."""
    from ..device import resolve_device
    from .dac.init import _init_
    device = resolve_device(device)
    on_card = device.type == "cuda"
    cfg = cfg or DiaConfig()
    dac_cfg = dac_cfg or dac44k_config(snake_approx=on_card)
    with torch.device("meta"):
        dia = DiaModel(cfg)
    dia = init_dia_(dia.to(dtype).to_empty(device=device), seed)
    dac = _init_(DAC44(dac_cfg), torch.Generator(device="cpu").manual_seed(
        int(seed) + 1))
    dac = dac.to(device=device,
                 dtype=torch.bfloat16 if on_card else torch.float32)
    return DiaModels(dia=dia.eval().requires_grad_(False),
                     dac=dac.eval().requires_grad_(False), dtype=dtype,
                     keep_logits=keep_logits)
