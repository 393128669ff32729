"""The Fish S1-DAC decode path in plain float32 (published
autoencoder.py:264-373, 503-826, 879-998, 1128-1132) and the PCA unwhiten
between the DiT's latents and the codec (inference.py:86-99).

Latents (B, T, 80) -> PCA unwhiten -> the quantizer's post-module
(window-limited causal transformer) -> two upsampling stages (transposed
conv + ConvNeXt) -> the decoder (causal conv, four blocks of snake,
transposed conv and three dilated residual units, snake, conv, tanh) ->
audio (B, T * 2048).  The decoder has no transformer at run time, as
published.  Convolutions take their weights as the checkpoint stores
them, weight norm folded per call; snakes use the exact sin.  Under
`reference.lowered` every convolution, linear and attention product takes
operands of the lowered precision (activations per position, weights per
output channel).

`c` is the configuration's "codec" group (the published DACConfig).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import q as operand

Weights = Dict[str, torch.Tensor]
DILATIONS = (1, 3, 9)
# Every convolution's weight is drawn N(0, 0.02^2), the scale of DAC's
# init_weights.  Drawn N(0, 1/fan_in), the decoder's residual units grow
# the signal tenfold and more and saturate the closing tanh (over half of
# the samples at |a| > 0.99): a decoder that amplifies bfloat16 rounding to
# 0.12-0.22 of the audio, which a lower precision no longer stands out of.
CONV_STD = 0.02


# ---------------------------------------------------------------------------
# Parameter list of the decode path (names and scales as reference/dit.py)
# ---------------------------------------------------------------------------

def _conv(out: list, p: str, shape: tuple, weight_norm: bool, n_bias: int):
    """A conv's weight as stored (weight norm's (g, v) pair or a plain
    weight), drawn N(0, CONV_STD^2), and its bias."""
    if weight_norm:
        v = f"{p}.conv.parametrizations.weight.original1"
        out.append((v, shape, ("normal", CONV_STD)))
        out.append((f"{p}.conv.parametrizations.weight.original0",
                    (shape[0],) + (1,) * (len(shape) - 1), ("norm_of", v)))
    else:
        out.append((f"{p}.conv.weight", shape, ("normal", CONV_STD)))
    out.append((f"{p}.conv.bias", (n_bias,), ("zeros",)))


def _causal(out: list, p: str, cin: int, cout: int, k: int, groups: int = 1,
            weight_norm: bool = True):
    _conv(out, p, (cout, cin // groups, k), weight_norm, cout)


def _transposed(out: list, p: str, cin: int, cout: int, k: int,
                weight_norm: bool = True):
    _conv(out, p, (cin, cout, k), weight_norm, cout)


def _lin(out: list, p: str, n_out: int, n_in: int, bias: bool):
    out.append((f"{p}.weight", (n_out, n_in), ("normal", n_in ** -0.5)))
    if bias:
        out.append((f"{p}.bias", (n_out,), ("zeros",)))


def _convnext_specs(out: list, p: str, d: int):
    _causal(out, f"{p}.dwconv", d, d, 7, groups=d, weight_norm=False)
    out.append((f"{p}.norm.weight", (d,), ("ones",)))
    out.append((f"{p}.norm.bias", (d,), ("zeros",)))
    _lin(out, f"{p}.pwconv1", 4 * d, d, True)
    _lin(out, f"{p}.pwconv2", d, 4 * d, True)
    out.append((f"{p}.gamma", (d,), ("const", 1e-6)))


def transformer_config(c: dict) -> dict:
    d = c["latent_dim"]
    return {"n_layer": c["quantizer_transformer_layers"], "n_head": d // 64,
            "dim": d, "inter": 3 * d, "head_dim": 64, "window": 128,
            "eps": 1e-5, "rope_base": 10000.0}


def specs(c: dict) -> List[Tuple[str, tuple, tuple]]:
    """The decode path's parameters (quantizer post-module and upsample,
    decoder), in a fixed order."""
    out: list = []
    t = transformer_config(c)
    d = t["dim"]
    for i in range(t["n_layer"]):
        p = f"quantizer.post_module.layers.{i}"
        _lin(out, f"{p}.attention.wqkv", 3 * d, d, False)
        _lin(out, f"{p}.attention.wo", d, d, False)
        _lin(out, f"{p}.feed_forward.w1", t["inter"], d, False)
        _lin(out, f"{p}.feed_forward.w3", t["inter"], d, False)
        _lin(out, f"{p}.feed_forward.w2", d, t["inter"], False)
        out.append((f"{p}.attention_norm.weight", (d,), ("ones",)))
        out.append((f"{p}.ffn_norm.weight", (d,), ("ones",)))
        out.append((f"{p}.attention_layer_scale.gamma", (d,), ("const", 1e-2)))
        out.append((f"{p}.ffn_layer_scale.gamma", (d,), ("const", 1e-2)))
    out.append(("quantizer.post_module.norm.weight", (d,), ("ones",)))
    for j, f in enumerate(reversed(c["downsample_factor"])):
        _transposed(out, f"quantizer.upsample.{j}.0", d, d, f,
                    weight_norm=False)
        _convnext_specs(out, f"quantizer.upsample.{j}.1", d)
    ch = c["decoder_dim"]
    _causal(out, "decoder.model.0", d, ch, 7)
    for bi, stride in enumerate(c["decoder_rates"]):
        cin, cout = ch // 2 ** bi, ch // 2 ** (bi + 1)
        p = f"decoder.model.{bi + 1}.block"
        out.append((f"{p}.0.alpha", (1, cin, 1), ("ones",)))
        _transposed(out, f"{p}.1", cin, cout, 2 * stride)
        for u in range(len(DILATIONS)):
            q = f"{p}.{u + 2}.block"
            out.append((f"{q}.0.alpha", (1, cout, 1), ("ones",)))
            _causal(out, f"{q}.1", cout, cout, 7)
            out.append((f"{q}.2.alpha", (1, cout, 1), ("ones",)))
            _causal(out, f"{q}.3", cout, cout, 1)
    n = len(c["decoder_rates"])
    final = ch // 2 ** n
    out.append((f"decoder.model.{n + 1}.alpha", (1, final, 1), ("ones",)))
    _causal(out, f"decoder.model.{n + 2}", final, 1, 7)
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _mm(x, w):
    """x (..., K) @ w (N, K)^T."""
    return operand(x, -1) @ operand(w, 1).t()


def _folded(W: Weights, p: str) -> torch.Tensor:
    """A conv's weight, weight norm folded: g * v / ||v|| over all axes but 0."""
    if f"{p}.conv.weight" in W:
        return W[f"{p}.conv.weight"]
    g = W[f"{p}.conv.parametrizations.weight.original0"]
    v = W[f"{p}.conv.parametrizations.weight.original1"]
    return g * v / torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True))


def causal_conv(W: Weights, p: str, x, *, stride=1, dilation=1, groups=1):
    """x (B, C, L): left pad k_eff - stride, right pad to a stride multiple."""
    w = operand(_folded(W, p), (1, 2))
    x = operand(x, 1)
    k_eff = (w.shape[-1] - 1) * dilation + 1
    extra = math.ceil(x.shape[-1] / stride) * stride - x.shape[-1]
    x = F.pad(x, (k_eff - stride, extra))
    return F.conv1d(x, w, W[f"{p}.conv.bias"], stride=stride,
                    dilation=dilation, groups=groups)


def causal_conv_transpose(W: Weights, p: str, x, *, stride: int):
    """Output length L * stride: the last K - stride samples are cut."""
    w = operand(_folded(W, p), (0, 2))
    out = F.conv_transpose1d(operand(x, 1), w, W[f"{p}.conv.bias"],
                             stride=stride)
    pad = w.shape[-1] - stride
    return out[..., :-pad] if pad > 0 else out


def snake(x, alpha):
    """x + sin^2(a x) / (a + 1e-9), alpha (1, C, 1)."""
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def _rope_table_bf16(s: int, dim: int, base: float, device):
    """The cos/sin table rounded to bfloat16, as published
    (autoencoder.py:805-813), applied in float32."""
    freqs = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device)[: dim // 2] / dim))
    ang = torch.outer(torch.arange(s, dtype=torch.float32, device=device),
                      freqs)
    table = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    return table.to(torch.bfloat16).float()


def _rope(x, table):
    xr = x.reshape(*x.shape[:-1], -1, 2)
    cos, sin = table[None, :, None, :, 0], table[None, :, None, :, 1]
    return torch.stack([xr[..., 0] * cos - xr[..., 1] * sin,
                        xr[..., 1] * cos + xr[..., 0] * sin], -1).reshape(x.shape)


def transformer(W: Weights, p: str, t: dict, x):
    """Window-limited causal transformer over (B, S, D)."""
    b, s, d = x.shape
    h, hd = t["n_head"], t["head_dim"]
    table = _rope_table_bf16(s, hd, t["rope_base"], x.device)
    i = torch.arange(s, device=x.device)[:, None]
    j = torch.arange(s, device=x.device)[None, :]
    keep = (j <= i) & (j > i - t["window"])
    for li in range(t["n_layer"]):
        q_ = f"{p}.layers.{li}"
        xn = _rms(x, W[f"{q_}.attention_norm.weight"], t["eps"])
        q, k, v = _mm(xn, W[f"{q_}.attention.wqkv.weight"]).chunk(3, -1)
        q = _rope(q.reshape(b, s, h, hd), table)
        k = _rope(k.reshape(b, s, h, hd), table)
        logits = torch.einsum("bshd,bthd->bhst", operand(q, -1),
                              operand(k, -1)) / math.sqrt(hd)
        w = torch.softmax(logits.masked_fill(~keep, float("-inf")), -1)
        o = torch.einsum("bhst,bthd->bshd", operand(w, -1),
                         operand(v.reshape(b, s, h, hd), 1))
        x = x + W[f"{q_}.attention_layer_scale.gamma"] * _mm(
            o.reshape(b, s, d), W[f"{q_}.attention.wo.weight"])
        xn = _rms(x, W[f"{q_}.ffn_norm.weight"], t["eps"])
        ff = f"{q_}.feed_forward"
        y = (F.silu(_mm(xn, W[f"{ff}.w1.weight"]))
             * _mm(xn, W[f"{ff}.w3.weight"]))
        x = x + W[f"{q_}.ffn_layer_scale.gamma"] * _mm(
            y, W[f"{ff}.w2.weight"])
    return _rms(x, W[f"{p}.norm.weight"], t["eps"])


def _convnext(W: Weights, p: str, x):
    """x (B, C, L)."""
    y = causal_conv(W, f"{p}.dwconv", x, groups=x.shape[1]).transpose(1, 2)
    y = F.layer_norm(y, (y.shape[-1],), W[f"{p}.norm.weight"],
                     W[f"{p}.norm.bias"], 1e-6)
    y = F.gelu(_mm(y, W[f"{p}.pwconv1.weight"]) + W[f"{p}.pwconv1.bias"])
    y = _mm(y, W[f"{p}.pwconv2.weight"]) + W[f"{p}.pwconv2.bias"]
    return x + (W[f"{p}.gamma"] * y).transpose(1, 2)


def pca_unwhiten(latents, pca: Weights):
    return (latents / pca["latent_scale"]) @ pca["components"] + pca["mean"]


def decode(W: Weights, c: dict, pca: Weights, latents) -> torch.Tensor:
    """latents (B, T, 80) -> audio (B, T * 2048), float32."""
    z = transformer(W, "quantizer.post_module", transformer_config(c),
                    pca_unwhiten(latents.float(), pca))
    x = z.transpose(1, 2)
    for j, f in enumerate(reversed(c["downsample_factor"])):
        x = causal_conv_transpose(W, f"quantizer.upsample.{j}.0", x, stride=f)
        x = _convnext(W, f"quantizer.upsample.{j}.1", x)
    x = causal_conv(W, "decoder.model.0", x)
    for bi, stride in enumerate(c["decoder_rates"]):
        p = f"decoder.model.{bi + 1}.block"
        x = causal_conv_transpose(W, f"{p}.1", snake(x, W[f"{p}.0.alpha"]),
                                  stride=stride)
        for u, dil in enumerate(DILATIONS):
            q = f"{p}.{u + 2}.block"
            y = causal_conv(W, f"{q}.1", snake(x, W[f"{q}.0.alpha"]),
                            dilation=dil)
            x = x + causal_conv(W, f"{q}.3", snake(y, W[f"{q}.2.alpha"]))
    n = len(c["decoder_rates"])
    x = snake(x, W[f"decoder.model.{n + 1}.alpha"])
    return torch.tanh(causal_conv(W, f"decoder.model.{n + 2}", x))[:, 0]
