"""Fish S1-DAC codec top level, NLC layout.

Counterpart of echo_tts_tpu/models/dac/dac.py (reference:
autoencoder.py:839-1138).  The modules are named after the reference
module tree, so `S1DAC().state_dict()` keys are the published checkpoint's
(echo_tts_tpu/tools/convert_dac.py:27-130 spells them); weight-normed convs
hold the checkpoint's (original0, original1) pair and fold it per call
(models/dac/conv.py).

Reference quirks kept: the decoder has NO transformer at runtime
(config.py); the encoder right-pads the audio to a frame_length multiple;
codes are clamped before the lookup; the decoder's snakes take the
polynomial sin^2 only when cfg.snake_approx is set (the bf16 serving
codec), the encoder always runs exact sin.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...config import DACConfig
from ...ops.res_stack import (DILATIONS, KERNEL_WIDTHS, ResStackWeights,
                               fused_res_stack, res_stack_eligible)
from .conv import (CausalConv, CausalConvTranspose, ConvNeXtBlock,
                   ResidualUnit, Snake1d, snake)
from .quantize import ResidualVectorQuantize, rvq_encode, rvq_from_codes
from .transformer import WindowLimitedTransformer, transformer_forward


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class EncoderBlock(nn.Module):
    """block = [3 residual units, Snake, strided conv (, transformer)]."""

    def __init__(self, cfg: DACConfig, in_dim: int, out_dim: int, stride: int,
                 n_t: int):
        super().__init__()
        mods = [ResidualUnit(in_dim, d) for d in DILATIONS]
        mods += [Snake1d(in_dim),
                 CausalConv(in_dim, out_dim, 2 * stride, stride=stride)]
        if n_t:
            mods.append(WindowLimitedTransformer(
                cfg.encoder_transformer_config(out_dim, n_t)))
        self.block = nn.ModuleList(mods)


class Encoder(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        dim = cfg.encoder_dim
        mods = [CausalConv(1, dim, 7)]
        for stride, n_t in zip(cfg.encoder_rates, cfg.encoder_transformer_layers):
            mods.append(EncoderBlock(cfg, dim, dim * 2, stride, n_t))
            dim *= 2
        mods += [Snake1d(dim), CausalConv(dim, cfg.latent_dim, 3)]
        self.block = nn.ModuleList(mods)


class DecoderBlock(nn.Module):
    """block = [Snake, transposed conv, 3 residual units]."""

    def __init__(self, in_dim: int, out_dim: int, stride: int):
        super().__init__()
        self.block = nn.ModuleList(
            [Snake1d(in_dim),
             CausalConvTranspose(in_dim, out_dim, 2 * stride, stride=stride)]
            + [ResidualUnit(out_dim, d) for d in DILATIONS])


class Decoder(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        ch = cfg.decoder_dim
        mods = [CausalConv(cfg.latent_dim, ch, 7)]
        for bi, stride in enumerate(cfg.decoder_rates):
            mods.append(DecoderBlock(ch // 2 ** bi, ch // 2 ** (bi + 1), stride))
        final = ch // 2 ** len(cfg.decoder_rates)
        mods += [Snake1d(final), CausalConv(final, 1, 7)]
        self.model = nn.ModuleList(mods)


class Quantizer(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        d = cfg.latent_dim
        self.downsample = nn.ModuleList(
            nn.ModuleList([CausalConv(d, d, f, stride=f, weight_norm=False),
                           ConvNeXtBlock(d)])
            for f in cfg.downsample_factor)
        self.upsample = nn.ModuleList(
            nn.ModuleList([CausalConvTranspose(d, d, f, stride=f,
                                               weight_norm=False),
                           ConvNeXtBlock(d)])
            for f in reversed(cfg.downsample_factor))
        qcfg = cfg.quantizer_transformer_config()
        self.pre_module = WindowLimitedTransformer(qcfg)
        self.post_module = WindowLimitedTransformer(qcfg)
        self.semantic_quantizer = ResidualVectorQuantize(
            1, d, cfg.semantic_codebook_size, cfg.codebook_dim)
        self.quantizer = ResidualVectorQuantize(
            cfg.n_codebooks, d, cfg.codebook_size, cfg.codebook_dim)


class S1DAC(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantizer = Quantizer(cfg)


# ---------------------------------------------------------------------------
# Residual stacks, encoder and decoder
# ---------------------------------------------------------------------------

def _stack_weights(units) -> ResStackWeights:
    """The three units' weights for the kernel, kept on the first unit and
    rebuilt only when a parameter moves to new storage or is edited in
    place (a load, `.to()`): the kernel-layout copy is then made once per
    codec, not once per launch."""
    params = [p for u in units for p in u.parameters()]
    key = tuple((p.data_ptr(), -1 if p.is_inference() else p._version)
                for p in params)
    cached = getattr(units[0], "_res_stack_weights", None)
    if cached is None or cached[0] != key:
        def stack(fn):
            return torch.stack([fn(u) for u in units])
        weights = ResStackWeights(
            stack(lambda u: u.block[1].conv.kernel()),
            stack(lambda u: u.block[1].conv.bias),
            stack(lambda u: u.block[0].vec()),
            stack(lambda u: u.block[3].conv.kernel()[0]),
            stack(lambda u: u.block[3].conv.bias),
            stack(lambda u: u.block[2].vec()))
        cached = (key, weights)
        units[0]._res_stack_weights = cached
    return cached[1]


def _res_stack(units, x: torch.Tensor, approx_snake: bool = False,
               history=None):
    """Three dilated residual units: the hand-written kernel on a CUDA
    tensor at C <= 384 (ops/res_stack.py), the unrolled units otherwise.

    The streaming callers (models/dac/streaming.py) pass `history`, the
    three units' (B, 6d, C) tails of snake1 of their inputs, and get
    (out, new history): through the kernel's history form at the kernel's
    widths (on the CPU its plain version), else through the unrolled
    units' history form, as the one-shot path runs them above C = 384
    (the base decoder's first block, C = 768)."""
    kernel_width = x.shape[2] <= KERNEL_WIDTHS[-1]
    if res_stack_eligible(x) or (history is not None and kernel_width):
        return fused_res_stack(x, _stack_weights(units),
                               approx_snake=approx_snake, history=history)
    if history is None:
        for u in units:
            x = u(x, approx_snake=approx_snake)
        return x
    new_history = []
    for u, h in zip(units, history):
        x, h = u(x, approx_snake=approx_snake, history=h)
        new_history.append(h)
    return x, new_history


def encoder_forward(enc: Encoder, cfg: DACConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, L, 1) -> (B, L/hop, latent_dim) (autoencoder.py:903-929)."""
    x = enc.block[0](audio)
    for blk in enc.block[1:1 + len(cfg.encoder_rates)]:
        x = _res_stack(blk.block[:3], x)
        x = snake(x, blk.block[3].vec())
        x = blk.block[4](x)
        if len(blk.block) > 5:
            tr = blk.block[5]
            x = transformer_forward(
                tr, cfg.encoder_transformer_config(x.shape[-1], len(tr.layers)), x)
    n = len(cfg.encoder_rates)
    x = snake(x, enc.block[n + 1].vec())
    return enc.block[n + 2](x)


def decoder_forward(dec: Decoder, cfg: DACConfig, z: torch.Tensor) -> torch.Tensor:
    """z (B, T, latent_dim) -> audio (B, T*hop, 1) in [-1, 1]
    (autoencoder.py:932-998)."""
    ap = cfg.snake_approx
    x = dec.model[0](z)
    for blk in dec.model[1:1 + len(cfg.decoder_rates)]:
        x = snake(x, blk.block[0].vec(), approx=ap)
        x = blk.block[1](x)
        x = _res_stack(blk.block[2:5], x, approx_snake=ap)
    n = len(cfg.decoder_rates)
    x = snake(x, dec.model[n + 1].vec(), approx=ap)
    return torch.tanh(dec.model[n + 2](x))


# ---------------------------------------------------------------------------
# Quantizer
# ---------------------------------------------------------------------------

def quantizer_encode_codes(q: Quantizer, cfg: DACConfig,
                           z: torch.Tensor) -> torch.Tensor:
    """Encoder output (B, T, D) -> codes (B, 1 + n_codebooks, T/4)
    (autoencoder.py:451-469, eval path)."""
    for conv, convnext in q.downsample:
        z = convnext(conv(z))
    z = transformer_forward(q.pre_module, cfg.quantizer_transformer_config(), z)
    sem_zq, sem_codes = rvq_encode(q.semantic_quantizer, z)
    _, res_codes = rvq_encode(q.quantizer, z - sem_zq)
    return torch.cat([sem_codes, res_codes], dim=1)


def zq_from_codes(q: Quantizer, cfg: DACConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, 1 + n, T) -> z_q (B, T, D): clamp, then sum semantic +
    residual from_codes (autoencoder.py:1117-1126)."""
    sem = torch.clamp(codes[:, :1], 0, cfg.semantic_codebook_size - 1)
    res = torch.clamp(codes[:, 1:], 0, cfg.codebook_size - 1)
    return (rvq_from_codes(q.semantic_quantizer, sem)
            + rvq_from_codes(q.quantizer, res))


# ---------------------------------------------------------------------------
# DAC top (autoencoder.py:1001-1138)
# ---------------------------------------------------------------------------

def encode_codes(model: S1DAC, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, L, 1) -> codes; right-pads to a frame_length multiple
    (autoencoder.py:1088-1100)."""
    cfg = model.cfg
    length = audio.shape[1]
    right = math.ceil(length / cfg.frame_length) * cfg.frame_length - length
    audio = F.pad(audio, (0, 0, 0, right))
    z = encoder_forward(model.encoder, cfg, audio)
    return quantizer_encode_codes(model.quantizer, cfg, z)


def encode_zq(model: S1DAC, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, L, 1) -> z_q (B, ceil(L/frame_length), latent_dim)."""
    return zq_from_codes(model.quantizer, model.cfg, encode_codes(model, audio))


def decode_zq(model: S1DAC, z_q: torch.Tensor) -> torch.Tensor:
    """z_q (B, T, latent_dim) -> audio (B, T*frame_length, 1)
    (autoencoder.py:1128-1132)."""
    cfg = model.cfg
    q = model.quantizer
    z = transformer_forward(q.post_module, cfg.quantizer_transformer_config(), z_q)
    for convt, convnext in q.upsample:
        z = convnext(convt(z))
    return decoder_forward(model.decoder, cfg, z)


def decode_codes(model: S1DAC, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, 1 + n_codebooks, T) -> audio (B, T*frame_length, 1):
    the quantizer's lookup, then decode_zq (autoencoder.py:486-496,
    1102-1108)."""
    return decode_zq(model, zq_from_codes(model.quantizer, model.cfg, codes))


# ---------------------------------------------------------------------------
# Analytic delay and length plumbing (autoencoder.py:1044-1108)
# ---------------------------------------------------------------------------

def _conv_layer_specs(cfg: DACConfig):
    """Ordered (is_transpose, kernel, stride, dilation) for every conv, in
    the reference's module-registration order."""
    specs = [(False, 7, 1, 1)]
    for stride in cfg.encoder_rates:
        for dil in DILATIONS:
            specs += [(False, 7, 1, dil), (False, 1, 1, 1)]
        specs.append((False, 2 * stride, stride, 1))
    specs.append((False, 3, 1, 1))
    for _ in range(1 + cfg.n_codebooks):
        specs += [(False, 1, 1, 1), (False, 1, 1, 1)]
    for factor in cfg.downsample_factor:
        specs += [(False, factor, factor, 1), (False, 7, 1, 1)]
    for factor in reversed(cfg.downsample_factor):
        specs += [(True, factor, factor, 1), (False, 7, 1, 1)]
    specs.append((False, 7, 1, 1))
    for stride in cfg.decoder_rates:
        specs.append((True, 2 * stride, stride, 1))
        for dil in DILATIONS:
            specs += [(False, 7, 1, dil), (False, 1, 1, 1)]
    specs.append((False, 7, 1, 1))
    return specs


def get_output_length(cfg: DACConfig, input_length: int) -> int:
    length = input_length
    for stride in cfg.encoder_rates:
        length = math.ceil(length / stride)
    return length


def get_delay(cfg: DACConfig) -> int:
    """Analytic codec delay in samples (autoencoder.py:1052-1068)."""
    l_out = get_output_length(cfg, 0)
    length = l_out
    for is_t, k, s, d in reversed(_conv_layer_specs(cfg)):
        if is_t:
            length = (length - d * (k - 1) - 1) / s + 1
        else:
            length = (length - 1) * s + d * (k - 1) + 1
        length = math.ceil(length)
    return (length - l_out) // 2


def encode_with_lengths(model: S1DAC, audio: torch.Tensor,
                        audio_lengths: Optional[torch.Tensor] = None):
    """encode_codes with per-item lengths (autoencoder.py:1080-1100):
    (codes (B, 1 + n_codebooks, T), indices_lens (B,) int32 =
    ceil(valid samples / frame_length)); without audio_lengths every item
    is the whole right-padded audio."""
    cfg = model.cfg
    length = audio.shape[1]
    right = math.ceil(length / cfg.frame_length) * cfg.frame_length - length
    if audio_lengths is None:
        audio_lengths = torch.full((audio.shape[0],), length + right,
                                   dtype=torch.int32, device=audio.device)
    codes = encode_codes(model, audio)
    indices_lens = torch.ceil(audio_lengths / cfg.frame_length).to(torch.int32)
    return codes, indices_lens


def decode_with_lengths(model: S1DAC, codes: torch.Tensor,
                        feature_lengths: torch.Tensor):
    """decode_codes with lengths (autoencoder.py:1102-1108): (audio
    (B, T*frame_length, 1), audio_lengths (B,) = feature_lengths *
    frame_length)."""
    return (decode_codes(model, codes),
            feature_lengths * model.cfg.frame_length)


# ---------------------------------------------------------------------------
# PCA whitening between codec space and DiT latent space
# (reference: inference.py:86-99, 218-229)
# ---------------------------------------------------------------------------

def pca_whiten(z_q: torch.Tensor, pca: dict) -> torch.Tensor:
    """(z_q - mean) @ W^T * scale, fp32."""
    z = (z_q.float() - pca["mean"]) @ pca["components"].T
    return z * pca["latent_scale"]


def pca_unwhiten(latents: torch.Tensor, pca: dict) -> torch.Tensor:
    """(z / scale) @ W + mean, fp32."""
    return (latents / pca["latent_scale"]) @ pca["components"] + pca["mean"]
