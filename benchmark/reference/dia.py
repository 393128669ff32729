"""Dia-1.6B and Descript's DAC 44 kHz decode in plain float32: the
benchmark's copy of echo_tts_torch/models/dia_reference.py, whose products'
operands pass through this package's `q` (reference.lowered: the check's
control), and whose `fp32` is the package's.

Written from the public dia/layers.py and dia/model.py and Descript's
dac/model/dac.py, with no kernel, cache, program or batching, and
importing nothing of the port (nor JAX).  Every product runs in float32
with TF32 off (`fp32`); `operand` is where a product's operands pass (the
benchmark's copy, benchmark/reference/dia.py, rounds them there for its
control).  Weights are dicts of float32 tensors keyed as the port's
modules name them (`specs` lists names, shapes and draws); `cfg` is a
dict of config.DiaConfig's fields, `c` one of DACConfig's.

  * `forward`: the full teacher-forced pass of the encoder and the
    decoder over a request's conditional row (its text) and unconditional
    row (every byte 0 under the conditional row's mask): logits at every
    position of the delayed token sequence, no cache;
  * `delayed_sequence`: that sequence for a prompt, the generated codes
    and the flush (BOS, the prompt, the codes, EOS at each channel's
    delay past the last frame, PAD after), delayed;
  * `sample_next_token`: the guidance and the published filters, drawn
    at given uniforms (`off_draw` holds a sampler's codes to it);
    `uniforms`: the port's seeded draws;
  * `codec_decode`: codes -> the codebooks' sum -> the centred decoder ->
    tanh.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fp32  # noqa: F401
from . import q as operand

Weights = Dict[str, torch.Tensor]
DILATIONS = (1, 3, 9)
# The codec's convolutions drawn N(0, 0.02^2), DAC's init_weights scale
CONV_STD = 0.02




# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _lin(out: list, name: str, n_out: int, n_in: int, std=None):
    out.append((f"{name}.weight", (n_out, n_in),
                ("normal", n_in ** -0.5 if std is None else std)))


def _attn(out: list, p: str, q_dim: int, kv_dim: int, heads: int,
          kv_heads: int, hd: int):
    # q drawn N(0, 1 / (fan_in * hd)): layers.py's logits are unscaled
    _lin(out, f"{p}.q_proj", heads * hd, q_dim, (q_dim * hd) ** -0.5)
    _lin(out, f"{p}.k_proj", kv_heads * hd, kv_dim)
    _lin(out, f"{p}.v_proj", kv_heads * hd, kv_dim)
    _lin(out, f"{p}.o_proj", q_dim, heads * hd)


def _norm(out: list, name: str, d: int):
    out.append((f"{name}.weight", (d,), ("ones",)))


def specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """Dia's parameters in a fixed order: linear weights (out, in) drawn
    N(0, 1 / fan_in) but the q projections, embeddings N(0, 1), norms 1."""
    out: list = []
    de, dd = cfg["encoder_n_embd"], cfg["decoder_n_embd"]
    out.append(("encoder.embedding.weight", (cfg["src_vocab_size"], de),
                ("normal", 1.0)))
    for i in range(cfg["encoder_n_layer"]):
        p = f"encoder.layers.{i}"
        _norm(out, f"{p}.pre_sa_norm", de)
        _attn(out, f"{p}.self_attention", de, de, cfg["encoder_n_head"],
              cfg["encoder_n_head"], cfg["encoder_head_dim"])
        _norm(out, f"{p}.post_sa_norm", de)
        _lin(out, f"{p}.mlp.wi_fused", 2 * cfg["encoder_n_hidden"], de)
        _lin(out, f"{p}.mlp.wo", de, cfg["encoder_n_hidden"])
    _norm(out, "encoder.norm", de)
    for c in range(cfg["channels"]):
        out.append((f"decoder.embeddings.{c}.weight",
                    (cfg["tgt_vocab_size"], dd), ("normal", 1.0)))
    for i in range(cfg["decoder_n_layer"]):
        p = f"decoder.layers.{i}"
        _norm(out, f"{p}.pre_sa_norm", dd)
        _attn(out, f"{p}.self_attention", dd, dd, cfg["gqa_query_heads"],
              cfg["kv_heads"], cfg["gqa_head_dim"])
        _norm(out, f"{p}.pre_ca_norm", dd)
        _attn(out, f"{p}.cross_attention", dd, de, cfg["cross_query_heads"],
              cfg["cross_query_heads"], cfg["cross_head_dim"])
        _norm(out, f"{p}.pre_mlp_norm", dd)
        _lin(out, f"{p}.mlp.wi_fused", 2 * cfg["decoder_n_hidden"], dd)
        _lin(out, f"{p}.mlp.wo", dd, cfg["decoder_n_hidden"])
    _norm(out, "decoder.norm", dd)
    _lin(out, "decoder.logits_dense",
         cfg["channels"] * cfg["tgt_vocab_size"], dd)
    return out


def _conv(out: list, p: str, shape: tuple):
    """A weight-normed conv's (g, v) and bias under the module path p, v
    drawn N(0, CONV_STD^2), g = ||v||."""
    v = f"{p}.parametrizations.weight.original1"
    out.append((v, shape, ("normal", CONV_STD)))
    out.append((f"{p}.parametrizations.weight.original0",
                (shape[0],) + (1,) * (len(shape) - 1), ("norm_of", v)))
    out.append((f"{p}.bias", (shape[0],), ("zeros",)))


def codec_specs(c: dict) -> List[Tuple[str, tuple, tuple]]:
    """The decode path's parameters: the codebooks (N(0, 1)) and their out
    projections, then the decoder, named as the port's DAC44 module."""
    out: list = []
    d = c["latent_dim"]
    for i in range(c["n_codebooks"]):
        p = f"quantizer.quantizers.{i}"
        out.append((f"{p}.codebook.weight",
                     (c["codebook_size"], c["codebook_dim"]), ("normal", 1.0)))
        _conv(out, f"{p}.out_proj", (d, c["codebook_dim"], 1))
    ch = c["decoder_dim"]
    _conv(out, "decoder.model.0.conv", (ch, d, 7))
    for bi, stride in enumerate(c["decoder_rates"]):
        cin, cout = ch // 2 ** bi, ch // 2 ** (bi + 1)
        p = f"decoder.model.{bi + 1}.block"
        out.append((f"{p}.0.alpha", (1, cin, 1), ("ones",)))
        _tconv(out, f"{p}.1.conv", (cin, cout, 2 * stride))
        for u in range(len(DILATIONS)):
            q = f"{p}.{u + 2}.block"
            out.append((f"{q}.0.alpha", (1, cout, 1), ("ones",)))
            _conv(out, f"{q}.1.conv", (cout, cout, 7))
            out.append((f"{q}.2.alpha", (1, cout, 1), ("ones",)))
            _conv(out, f"{q}.3.conv", (cout, cout, 1))
    n = len(c["decoder_rates"])
    final = ch // 2 ** n
    out.append((f"decoder.model.{n + 1}.alpha", (1, final, 1), ("ones",)))
    _conv(out, f"decoder.model.{n + 2}.conv", (1, final, 7))
    return out


def _tconv(out: list, p: str, shape: tuple):
    """A weight-normed transposed conv, torch layout (C_in, C_out, K)."""
    v = f"{p}.parametrizations.weight.original1"
    out.append((v, shape, ("normal", CONV_STD)))
    out.append((f"{p}.parametrizations.weight.original0",
                (shape[0], 1, 1), ("norm_of", v)))
    out.append((f"{p}.bias", (shape[1],), ("zeros",)))


# ---------------------------------------------------------------------------
# Dia
# ---------------------------------------------------------------------------

def _mm(x, w):
    """x (..., K) @ w (N, K)^T."""
    return operand(x, -1) @ operand(w, 1).t()


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def _rope(x, positions, cfg: dict):
    """x (R, S, H, hd), positions (S,): split halves, fp32."""
    hd = x.shape[-1]
    frac = 2.0 * torch.arange(hd // 2, dtype=torch.float32,
                              device=x.device) / hd
    lo, hi = cfg["rope_min_timescale"], cfg["rope_max_timescale"]
    ang = positions.float()[:, None, None] / (lo * (hi / lo) ** frac)
    a, b = x.chunk(2, -1)
    return torch.cat([a * torch.cos(ang) - b * torch.sin(ang),
                      b * torch.cos(ang) + a * torch.sin(ang)], -1)


def _attention(W, p: str, xq, xkv, pos_q, pos_kv, keep, heads, kv_heads,
               cfg: dict):
    """Softmax attention with scale 1 (layers.py); keep (R, Sq, Sk) bool;
    each query head h reads K/V head h // (heads / kv_heads)."""
    r, sq, _ = xq.shape
    sk = xkv.shape[1]
    q = _rope(_mm(xq, W[f"{p}.q_proj.weight"]).view(r, sq, heads, -1),
              pos_q, cfg)
    k = _rope(_mm(xkv, W[f"{p}.k_proj.weight"]).view(r, sk, kv_heads, -1),
              pos_kv, cfg)
    v = _mm(xkv, W[f"{p}.v_proj.weight"]).view(r, sk, kv_heads, -1)
    g = heads // kv_heads
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    logit = torch.einsum("rshd,rthd->rhst", operand(q, -1), operand(k, -1))
    w = torch.softmax(logit.masked_fill(~keep[:, None], float("-inf")), -1)
    o = torch.einsum("rhst,rthd->rshd", operand(w, -1), operand(v, 1))
    return _mm(o.reshape(r, sq, -1), W[f"{p}.o_proj.weight"])


def _mlp(W, p: str, x):
    gate, up = _mm(x, W[f"{p}.wi_fused.weight"]).chunk(2, -1)
    return _mm(F.silu(gate) * up, W[f"{p}.wo.weight"])


def encode(W: Weights, cfg: dict, ids: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """ids (R, T), valid (R, T) -> (R, T, D_enc): valid attends to valid,
    pad to pad."""
    eps = cfg["normalization_layer_epsilon"]
    x = W["encoder.embedding.weight"][ids]
    keep = valid[:, :, None] == valid[:, None, :]
    pos = torch.arange(ids.shape[1], device=ids.device)
    h_, hd = cfg["encoder_n_head"], cfg["encoder_head_dim"]
    for i in range(cfg["encoder_n_layer"]):
        p = f"encoder.layers.{i}"
        h = _rms(x, W[f"{p}.pre_sa_norm.weight"], eps)
        x = x + _attention(W, f"{p}.self_attention", h, h, pos, pos, keep,
                           h_, h_, cfg)
        x = x + _mlp(W, f"{p}.mlp", _rms(x, W[f"{p}.post_sa_norm.weight"],
                                         eps))
    return _rms(x, W["encoder.norm.weight"], eps)


def decode_logits(W: Weights, cfg: dict, enc: torch.Tensor,
                  valid: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The decoder's full causal pass: tokens (R, S, channels) over the
    encoded text enc (R, T, D_enc) under valid (R, T) -> logits (R, S,
    channels, vocab)."""
    eps = cfg["normalization_layer_epsilon"]
    r, s, ch = tokens.shape
    x = sum(W[f"decoder.embeddings.{c}.weight"][tokens[..., c]]
            for c in range(ch))
    pos = torch.arange(s, device=tokens.device)
    tpos = torch.arange(enc.shape[1], device=tokens.device)
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).tril()[None].expand(r, s, s)
    cross = valid[:, None, :].expand(r, s, enc.shape[1])
    for i in range(cfg["decoder_n_layer"]):
        p = f"decoder.layers.{i}"
        h = _rms(x, W[f"{p}.pre_sa_norm.weight"], eps)
        x = x + _attention(W, f"{p}.self_attention", h, h, pos, pos, causal,
                           cfg["gqa_query_heads"], cfg["kv_heads"], cfg)
        h = _rms(x, W[f"{p}.pre_ca_norm.weight"], eps)
        x = x + _attention(W, f"{p}.cross_attention", h, enc, pos, tpos,
                           cross, cfg["cross_query_heads"],
                           cfg["cross_query_heads"], cfg)
        x = x + _mlp(W, f"{p}.mlp", _rms(x, W[f"{p}.pre_mlp_norm.weight"],
                                         eps))
    x = _rms(x, W["decoder.norm.weight"], eps)
    return _mm(x, W["decoder.logits_dense.weight"]).view(
        r, s, ch, cfg["tgt_vocab_size"])


def text_ids(text: str, cfg: dict) -> np.ndarray:
    """Dia's byte encoding: [S1] and [S2] as 0x01 and 0x02, padded with 0
    (or cut) to text_length."""
    b = text.encode("utf-8").replace(b"[S1]", b"\x01").replace(b"[S2]",
                                                              b"\x02")
    out = np.zeros(cfg["text_length"], np.int64)
    b = b[:cfg["text_length"]]
    out[:len(b)] = list(b)
    return out


def forward(W: Weights, cfg: dict, ids: torch.Tensor,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids (B, T) and tokens (B, S, channels) -> the conditional and the
    unconditional logits, each (B, S, channels, vocab)."""
    valid = ids != 0
    both = torch.cat([ids, torch.zeros_like(ids)])
    vboth = torch.cat([valid, valid])
    enc = encode(W, cfg, both, vboth)
    out = decode_logits(W, cfg, enc, vboth, torch.cat([tokens, tokens]))
    return out[:ids.shape[0]], out[ids.shape[0]:]


def delayed_sequence(cfg: dict, prompt: np.ndarray,
                     codes: np.ndarray) -> np.ndarray:
    """The tokens the decoder reads at positions 0 .. P + N + D - 1 (D the
    largest delay) for a prompt (P, channels) and generated codes (N,
    channels): channel c at position t holds frame f = t - 1 - d_c of
    [prompt | codes]; BOS for f < 0, EOS at f = P + N, PAD past it."""
    frames = np.concatenate([np.asarray(prompt, np.int64).reshape(
        -1, cfg["channels"]), np.asarray(codes, np.int64)])
    n = frames.shape[0]
    length = n + max(cfg["delay_pattern"])
    out = np.empty((length, cfg["channels"]), np.int64)
    t = np.arange(length)
    for c, d in enumerate(cfg["delay_pattern"]):
        f = t - 1 - d
        col = np.where(f < 0, cfg["audio_bos_value"],
                       np.where(f == n, cfg["audio_eos_value"],
                                cfg["audio_pad_value"]))
        inside = (f >= 0) & (f < n)
        col[inside] = frames[f[inside], c]
        out[:, c] = col
    return out


# ---------------------------------------------------------------------------
# The draw
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finaliser over uint64 arrays of 32-bit values."""
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(M32)
    x = x ^ (x >> np.uint64(13))
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(M32)
    return x ^ (x >> np.uint64(16))


def uniforms(seed: int, positions: np.ndarray, channels: int) -> np.ndarray:
    """The port's seeded draw in place of torch.multinomial's: for a
    request's seed, the positions it samples (S,) and each channel, a
    uniform in (0, 1) (S, channels) float32 from a counter hash of the
    seed's two 32-bit words, the position and the channel."""
    seed = int(seed) % (1 << 64)
    lo, hi = np.uint64(seed & M32), np.uint64(seed >> 32)
    pos = np.asarray(positions, np.uint64)[:, None]
    ch = np.arange(channels, dtype=np.uint64)[None]
    x = _fmix32((pos * np.uint64(channels) + ch + np.uint64(0x9E3779B9))
                & np.uint64(M32))
    x = _fmix32(x ^ hi)
    x = _fmix32(x ^ lo)
    return ((x >> np.uint64(8)).astype(np.float64) * 2.0 ** -24
            + 2.0 ** -25).astype(np.float32)


def guided(lc: torch.Tensor, lu: torch.Tensor, cfg: dict,
           sampler: dict) -> torch.Tensor:
    """Dia's guided logits over temperature: l_c + cfg_scale (l_c - l_u),
    EOS, PAD and BOS off (EOS held until the requested frames are out)."""
    logit = lc + sampler["cfg_scale"] * (lc - lu)
    logit = logit.clone()
    logit[..., cfg["audio_eos_value"]:] = float("-inf")
    return logit / sampler["temperature"]


def sample_next_token(lc: torch.Tensor, lu: torch.Tensor, u: torch.Tensor,
                      cfg: dict, sampler: dict, edge: float = 0.0):
    """Dia's guidance and _sample_next_token (dia/model.py), with the
    uniforms u (...) in place of torch.multinomial's draw: conditional and
    unconditional logits (..., vocab) -> (codes (...), on_edge (...)).

    `guided`; the top_k largest kept; then top_p: sorted by probability,
    a code is dropped once the codes before it hold more than top_p; the
    draw is the first code, in falling probability, whose cumulative
    probability passes u.  A draw is on an edge where rounding of size
    `edge` could change it: a cumulative probability within `edge` of
    top_p, or u within `edge` of a bin's end.  (Tied codes come in either
    order: `off_draw` accepts any code tied with the draw.)"""
    logit = guided(lc, lu, cfg, sampler)
    top = torch.topk(logit, sampler["top_k"], dim=-1).indices
    logit = logit.masked_fill(torch.ones_like(logit, dtype=torch.bool)
                              .scatter(-1, top, False), float("-inf"))
    probs = torch.softmax(logit, dim=-1)
    sp, si = torch.sort(probs, dim=-1, descending=True)
    cum = torch.cumsum(sp, dim=-1)
    drop = torch.roll(cum > sampler["top_p"], 1, dims=-1)
    drop[..., 0] = False
    logit = logit.masked_fill(torch.zeros_like(drop).scatter(-1, si, drop),
                              float("-inf"))
    final = torch.softmax(logit, dim=-1)
    fp, fi = torch.sort(final, dim=-1, descending=True)
    cdf = torch.cumsum(fp, dim=-1)
    target = u[..., None].to(cdf.dtype) * cdf[..., -1:]
    choice = (cdf <= target).sum(-1).clamp(max=cdf.shape[-1] - 1)
    codes = fi.gather(-1, choice[..., None])[..., 0]
    on_edge = (((cum - sampler["top_p"]).abs() < edge).any(-1)
               | ((cdf - target).abs() < edge).any(-1))
    return codes, on_edge


def off_draw(lc: torch.Tensor, lu: torch.Tensor, u: torch.Tensor,
             codes: torch.Tensor, cfg: dict, sampler: dict, edge: float):
    """Codes (...) a sampler drew from these logits at these uniforms,
    against `sample_next_token`: (off, on_edge), off where a code is not
    the reference's draw, nor tied with it (guided logits within `edge`),
    and the draw is not on an edge."""
    want, on_edge = sample_next_token(lc, lu, u, cfg, sampler, edge)
    g = guided(lc, lu, cfg, sampler)
    tied = (g.gather(-1, codes[..., None]) - g.gather(-1, want[..., None])
            ).abs()[..., 0] < edge
    return (codes != want) & ~tied & ~on_edge, on_edge

# ---------------------------------------------------------------------------
# DAC 44 kHz decode (centred)
# ---------------------------------------------------------------------------

def _folded(W: Weights, p: str) -> torch.Tensor:
    g = W[f"{p}.parametrizations.weight.original0"]
    v = W[f"{p}.parametrizations.weight.original1"]
    return g * v / torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True))


def _conv1d(W: Weights, p: str, x, dilation: int = 1):
    """x (B, C, L), WNConv1d (module path p) with padding (k - 1) * d / 2
    on each side."""
    w = operand(_folded(W, p), (1, 2))
    pad = (w.shape[-1] - 1) * dilation // 2
    return F.conv1d(operand(x, 1), w, W[f"{p}.bias"], padding=pad,
                    dilation=dilation)


def _conv_t(W: Weights, p: str, x, stride: int):
    """WNConvTranspose1d(kernel 2s, stride s, padding ceil(s / 2))."""
    w = operand(_folded(W, p), (0, 2))
    return F.conv_transpose1d(operand(x, 1), w, W[f"{p}.bias"],
                              stride=stride, padding=-(-stride // 2))


def _snake(x, alpha):
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


def codec_decode(W: Weights, c: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, n_codebooks, N) -> audio (B, N * hop): each codebook's
    entry out-projected and summed, then DAC's Decoder."""
    z = 0
    for i in range(c["n_codebooks"]):
        p = f"quantizer.quantizers.{i}"
        e = W[f"{p}.codebook.weight"][codes[:, i].clamp(
            0, c["codebook_size"] - 1)]
        z = z + _conv1d(W, f"{p}.out_proj", e.transpose(1, 2))
    x = _conv1d(W, "decoder.model.0.conv", z)
    for bi, stride in enumerate(c["decoder_rates"]):
        p = f"decoder.model.{bi + 1}.block"
        x = _conv_t(W, f"{p}.1.conv", _snake(x, W[f"{p}.0.alpha"]), stride)
        for u, dil in enumerate(DILATIONS):
            q = f"{p}.{u + 2}.block"
            y = _conv1d(W, f"{q}.1.conv", _snake(x, W[f"{q}.0.alpha"]), dil)
            x = x + _conv1d(W, f"{q}.3.conv", _snake(y, W[f"{q}.2.alpha"]))
    n = len(c["decoder_rates"])
    x = _snake(x, W[f"decoder.model.{n + 1}.alpha"])
    return torch.tanh(_conv1d(W, f"decoder.model.{n + 2}.conv", x))[:, 0]
