"""Seeded random initialization of the S1-DAC codec and the PCA state.

Counterpart of echo_tts_tpu/models/dac/init.py: the same scales (conv
kernels N(0, 1/fan_in), depthwise N(0, 1/7), codebooks N(0, 1), snake
alphas 1, LayerScale 1e-2, ConvNeXt gamma 1e-6, zero biases), not the same
bits.  Weight-normed convs get original1 = W and original0 = ||W||, so the
folded weight is W.
"""
from __future__ import annotations

import torch
from torch import nn

from ...config import DACConfig
from ...device import resolve_device
from .conv import ConvNeXtBlock, ConvWeights, Snake1d
from .dac import S1DAC
from .transformer import _LayerScale, _Norm


@torch.no_grad()
def _init_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    def normal(shape, std, device):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * std

    for mod in model.modules():
        if isinstance(mod, ConvWeights):
            dev = mod.bias.device
            w = normal(mod.torch_weight_shape, mod.fan_in ** -0.5, dev)
            if mod.weight_norm:
                pair = mod.parametrizations["weight"]
                pair.original1.copy_(w)
                pair.original0.copy_(torch.sqrt(torch.sum(
                    w * w, dim=tuple(range(1, w.ndim)), keepdim=True)))
            else:
                mod.weight.copy_(w)
            mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            mod.weight.copy_(normal(mod.weight.shape, mod.in_features ** -0.5,
                                    mod.weight.device))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(normal(mod.weight.shape, 1.0, mod.weight.device))
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (Snake1d,)):
            mod.alpha.fill_(1.0)
        elif isinstance(mod, _Norm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, _LayerScale):
            mod.gamma.fill_(1e-2)
        if isinstance(mod, ConvNeXtBlock):
            mod.gamma.fill_(1e-6)
    return model


def init_dac(cfg: DACConfig, *, device="cuda", dtype=torch.float32,
             seed: int = 0) -> S1DAC:
    """A seeded random-weight S1-DAC on `device` (raises without CUDA
    unless device='cpu')."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = S1DAC(cfg)
    model = model.to(dtype).to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _init_(model, gen).eval().requires_grad_(False)


def init_pca_params(latent_size: int = 80, codec_dim: int = 1024, *,
                    device="cuda", seed: int = 0) -> dict:
    """Random unit-row PCA state (reference: inference.py:86-99)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((latent_size, codec_dim), generator=gen, device=device,
                    dtype=torch.float32)
    w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
    return {"components": w,
            "mean": torch.zeros((codec_dim,), dtype=torch.float32, device=device),
            "latent_scale": 1.0}
