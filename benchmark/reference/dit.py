"""EchoDiT in plain float32 (published model.py:9-642): the byte-level
text encoder, the causal speaker patch encoder, the per-layer static K/V
and the denoiser over [self | text | speaker] with low-rank AdaLN.

`c` is the configuration's "dit" group (benchmark/configs/*.json): the
published EchoDiTConfig fields.  `W` maps checkpoint names to tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import q as operand

Weights = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Parameter list: (name, shape, init), init ("normal", std) | ("zeros",) |
# ("ones",): linear weights N(0, 1/fan_in), embeddings N(0, 1), biases 0,
# norm weights 1.
# ---------------------------------------------------------------------------

def _linear(out: list, name: str, n_out: int, n_in: int, bias: bool = False):
    out.append((f"{name}.weight", (n_out, n_in), ("normal", n_in ** -0.5)))
    if bias:
        out.append((f"{name}.bias", (n_out,), ("zeros",)))


def _encoder_block(out: list, p: str, d: int, heads: int, inter: int):
    for n in ("wq", "wk", "wv", "wo", "gate"):
        _linear(out, f"{p}.attention.{n}", d, d)
    out.append((f"{p}.attention.q_norm.weight", (heads, d // heads), ("ones",)))
    out.append((f"{p}.attention.k_norm.weight", (heads, d // heads), ("ones",)))
    _linear(out, f"{p}.mlp.w1", inter, d)
    _linear(out, f"{p}.mlp.w2", d, inter)
    _linear(out, f"{p}.mlp.w3", inter, d)
    out.append((f"{p}.attention_norm.weight", (d,), ("ones",)))
    out.append((f"{p}.mlp_norm.weight", (d,), ("ones",)))


def _patch_encoder(out: list, p: str, c: dict):
    _linear(out, f"{p}.in_proj", c["speaker_model_size"],
            c["latent_size"] * c["speaker_patch_size"], bias=True)
    for i in range(c["speaker_num_layers"]):
        _encoder_block(out, f"{p}.blocks.{i}", c["speaker_model_size"],
                       c["speaker_num_heads"], c["speaker_intermediate_size"])


def specs(c: dict) -> List[Tuple[str, tuple, tuple]]:
    """Every DiT parameter of the published checkpoint, in a fixed order."""
    m, dt, ds = c["model_size"], c["text_model_size"], c["speaker_model_size"]
    out: list = []
    out.append(("text_encoder.text_embedding.weight",
                (c["text_vocab_size"], dt), ("normal", 1.0)))
    for i in range(c["text_num_layers"]):
        _encoder_block(out, f"text_encoder.blocks.{i}", dt,
                       c["text_num_heads"], c["text_intermediate_size"])
    _patch_encoder(out, "speaker_encoder", c)
    out.append(("text_norm.weight", (dt,), ("ones",)))
    out.append(("speaker_norm.weight", (ds,), ("ones",)))
    if c["blockwise"]:
        _patch_encoder(out, "latent_encoder", c)
        out.append(("latent_norm.weight", (ds,), ("ones",)))
    _linear(out, "cond_module.0", m, c["timestep_embed_size"])
    _linear(out, "cond_module.2", m, m)
    _linear(out, "cond_module.4", 3 * m, m)
    _linear(out, "in_proj", m, c["latent_size"], bias=True)
    hd = m // c["num_heads"]
    for i in range(c["num_layers"]):
        p = f"blocks.{i}"
        for n in ("wq", "wk", "wv", "wo", "gate"):
            _linear(out, f"{p}.attention.{n}", m, m)
        for seg, width in (("text", dt), ("speaker", ds)):
            _linear(out, f"{p}.attention.wk_{seg}", m, width)
            _linear(out, f"{p}.attention.wv_{seg}", m, width)
        if c["blockwise"]:
            _linear(out, f"{p}.attention.wk_latent", m, ds)
            _linear(out, f"{p}.attention.wv_latent", m, ds)
        out.append((f"{p}.attention.q_norm.weight", (c["num_heads"], hd),
                    ("ones",)))
        out.append((f"{p}.attention.k_norm.weight", (c["num_heads"], hd),
                    ("ones",)))
        _linear(out, f"{p}.mlp.w1", c["intermediate_size"], m)
        _linear(out, f"{p}.mlp.w2", m, c["intermediate_size"])
        _linear(out, f"{p}.mlp.w3", c["intermediate_size"], m)
        for ln in ("attention_adaln", "mlp_adaln"):
            for n in ("shift", "scale", "gate"):
                _linear(out, f"{p}.{ln}.{n}_down", c["adaln_rank"], m)
                _linear(out, f"{p}.{ln}.{n}_up", m, c["adaln_rank"], bias=True)
    out.append(("out_norm.weight", (m,), ("ones",)))
    _linear(out, "out_proj", c["latent_size"], m, bias=True)
    return out


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

def linear(W: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    y = (operand(x, -1, name)
         @ operand(W[f"{name}.weight"], 1, name).t())
    b = W.get(f"{name}.bias")
    return y if b is None else y + b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope_table(dim: int, end: int, device) -> torch.Tensor:
    """(end, dim/2, 2) cos/sin of t * 10000^(-2j/dim)."""
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                            device=device)[: dim // 2] / dim))
    ang = torch.outer(torch.arange(end, dtype=torch.float64, device=device),
                      freqs)
    return torch.stack([torch.cos(ang), torch.sin(ang)], -1).float()


def rope(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved (even, odd) pairs of x (B, S, H, D); table (S, D/2, 2)."""
    xr = x.reshape(*x.shape[:-1], -1, 2)
    cos, sin = table[:, None, :, 0], table[:, None, :, 1]
    return torch.stack([xr[..., 0] * cos - xr[..., 1] * sin,
                        xr[..., 1] * cos + xr[..., 0] * sin], -1).reshape(x.shape)


def rope_half_heads(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """RoPE on the first half of the heads only (model.py:199-202)."""
    n = x.shape[-2] // 2
    return torch.cat([rope(x[..., :n, :], table), x[..., n:, :]], dim=-2)


def attention(q, k, v, keep=None):
    """q (B, S, H, D), k/v (B, T, H, D); keep broadcastable to (B, H, S, T)."""
    logits = torch.einsum("bshd,bthd->bhst", operand(q, -1), operand(k, -1)) \
        / math.sqrt(q.shape[-1])
    if keep is not None:
        logits = logits.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhst,bthd->bshd", operand(torch.softmax(logits, -1), -1),
                        operand(v, 1))


def _encoder(W: Weights, p: str, x, keep, n_layers: int, heads: int,
             eps: float, causal: bool):
    b, s, d = x.shape
    table = rope_table(d // heads, s, x.device)
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    for i in range(n_layers):
        q_ = f"{p}.blocks.{i}"
        h = rms_norm(x, W[f"{q_}.attention_norm.weight"], eps)
        a = f"{q_}.attention"
        q = rms_norm(linear(W, f"{a}.wq", h).reshape(b, s, heads, -1),
                     W[f"{a}.q_norm.weight"], eps)
        k = rms_norm(linear(W, f"{a}.wk", h).reshape(b, s, heads, -1),
                     W[f"{a}.k_norm.weight"], eps)
        v = linear(W, f"{a}.wv", h).reshape(b, s, heads, -1)
        o = attention(rope(q, table), rope(k, table), v, keep).reshape(b, s, d)
        x = x + linear(W, f"{a}.wo", o * torch.sigmoid(linear(W, f"{a}.gate", h)))
        h = rms_norm(x, W[f"{q_}.mlp_norm.weight"], eps)
        x = x + _mlp(W, f"{q_}.mlp", h)
    return x


def _mlp(W: Weights, p: str, x):
    return linear(W, f"{p}.w2", F.silu(linear(W, f"{p}.w1", x))
                  * linear(W, f"{p}.w3", x))


def _stacked_kv(W: Weights, c: dict, state, seg: str):
    """Per layer (K normed by the layer's k_norm, V): (L, B, T, H, Dh)."""
    b, t, _ = state.shape
    h = c["num_heads"]
    ks, vs = [], []
    for i in range(c["num_layers"]):
        a = f"blocks.{i}.attention"
        k = linear(W, f"{a}.wk_{seg}", state).reshape(b, t, h, -1)
        ks.append(rms_norm(k, W[f"{a}.k_norm.weight"], c["norm_eps"]))
        vs.append(linear(W, f"{a}.wv_{seg}", state).reshape(b, t, h, -1))
    return torch.stack(ks), torch.stack(vs)


def static_kv(W: Weights, c: dict, text_ids, text_mask, speaker_latent):
    """The text and speaker segments' K/V, concatenated [text, speaker]."""
    eps = c["norm_eps"]
    x = W["text_encoder.text_embedding.weight"][text_ids]
    x = _encoder(W, "text_encoder", x, text_mask[:, None, None, :],
                 c["text_num_layers"], c["text_num_heads"], eps, False)
    kt, vt = _stacked_kv(W, c, rms_norm(x, W["text_norm.weight"], eps), "text")
    b, s, d = speaker_latent.shape
    ps = c["speaker_patch_size"]
    x = linear(W, "speaker_encoder.in_proj",
               speaker_latent.reshape(b, s // ps, d * ps)) / 6.0
    x = _encoder(W, "speaker_encoder", x, None, c["speaker_num_layers"],
                 c["speaker_num_heads"], eps, True)
    ksp, vsp = _stacked_kv(W, c, rms_norm(x, W["speaker_norm.weight"], eps),
                           "speaker")
    return torch.cat([kt, ksp], 2), torch.cat([vt, vsp], 2)


def timestep_embedding(t, size: int):
    half = size // 2
    freqs = 1000.0 * torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def _adaln(W: Weights, p: str, x, cond, eps: float):
    m = x.shape[-1]
    outs = []
    for j, n in enumerate(("shift", "scale", "gate")):
        cj = cond[..., j * m:(j + 1) * m]
        outs.append(linear(W, f"{p}.{n}_up",
                           linear(W, f"{p}.{n}_down", F.silu(cj))) + cj)
    shift, scale, gate = outs
    xn = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)
    return xn * (scale + 1) + shift, torch.tanh(gate)


def denoiser(W: Weights, c: dict, x, t, k_static, v_static, static_keep):
    """v = DiT(x, t) over [self | static K/V] (model.py:563-604).

    x (GB, S, latent), t (GB,), k/v_static (L, B, T, H, Dh) with
    GB = G * B (G-major), static_keep (GB, T) bool."""
    gb, s, _ = x.shape
    b = k_static.shape[1]
    g = gb // b
    m, heads, eps = c["model_size"], c["num_heads"], c["norm_eps"]
    dh = m // heads
    table = rope_table(dh, s, x.device)
    cond = linear(W, "cond_module.0", timestep_embedding(
        t, c["timestep_embed_size"]))
    cond = linear(W, "cond_module.4", F.silu(linear(W, "cond_module.2",
                                                    F.silu(cond))))[:, None]
    h = linear(W, "in_proj", x)
    self_keep = torch.ones((gb, s), dtype=torch.bool, device=x.device)
    keep = torch.cat([self_keep, static_keep], 1)[:, None, None, :]
    for i in range(c["num_layers"]):
        p = f"blocks.{i}"
        a = f"{p}.attention"
        hn, gate = _adaln(W, f"{p}.attention_adaln", h, cond, eps)
        q = rms_norm(linear(W, f"{a}.wq", hn).reshape(gb, s, heads, dh),
                     W[f"{a}.q_norm.weight"], eps)
        k = rms_norm(linear(W, f"{a}.wk", hn).reshape(gb, s, heads, dh),
                     W[f"{a}.k_norm.weight"], eps)
        v = linear(W, f"{a}.wv", hn).reshape(gb, s, heads, dh)
        ks = k_static[i].repeat(g, 1, 1, 1)
        vs = v_static[i].repeat(g, 1, 1, 1)
        o = attention(rope_half_heads(q, table),
                      torch.cat([rope_half_heads(k, table), ks], 1),
                      torch.cat([v, vs], 1), keep).reshape(gb, s, m)
        h = h + gate * linear(W, f"{a}.wo",
                              o * torch.sigmoid(linear(W, f"{a}.gate", hn)))
        hn, gate = _adaln(W, f"{p}.mlp_adaln", h, cond, eps)
        h = h + gate * _mlp(W, f"{p}.mlp", hn)
    return linear(W, "out_proj", rms_norm(h, W["out_norm.weight"], eps))
