"""The port's checkpoint bundle: a whole EchoModels (DiT, codec, PCA) on
disk, which serve/models.py loads directly.

Counterpart of echo_tts_tpu/tools/checkpoint.py, whose bundle is an orbax
checkpoint (orbax is a JAX library).  Here the state dicts are
safetensors under the published keys:

  <dir>/config.json       {"dit_cfg", "dac_cfg", "dtype"} as the JAX
                          package writes them, plus "dit_quant": "none"
                          or "int8" (a W8A8 DiT keeps its int8 weights
                          and fp32 scales)
  <dir>/dit.safetensors   the DiT's state dict
  <dir>/dac.safetensors   the codec's state dict (in its own dtype)
  <dir>/pca.safetensors   components, mean, latent_scale
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from ..config import DACConfig, EchoDiTConfig
from ..device import resolve_device
from ..ops.quant import dit_is_quantized
from ..pipeline.pipeline import EchoModels
from .bridge import load_dac_state, load_dit_state

CONFIG = "config.json"
FILES = ("dit.safetensors", "dac.safetensors", "pca.safetensors")


def is_bundle(path: str) -> bool:
    """True for a directory in this bundle's layout (as opposed to the
    published safetensors that pipeline.load_models_from_dir reads)."""
    return all(os.path.isfile(os.path.join(path, f)) for f in (CONFIG,) + FILES)


def _state(module: torch.nn.Module) -> dict:
    return {k: v.detach().contiguous() for k, v in module.state_dict().items()}


def save_checkpoint(path: str, models: EchoModels) -> None:
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    dit_file, dac_file, pca_file = (os.path.join(path, f) for f in FILES)
    save_file(_state(models.dit), dit_file)
    save_file(_state(models.dac), dac_file)
    pca = models.pca
    save_file({"components": pca["components"].detach().float().contiguous(),
               "mean": pca["mean"].detach().float().contiguous(),
               # a Python float: float64 keeps it exactly
               "latent_scale": torch.tensor([pca["latent_scale"]],
                                            dtype=torch.float64)}, pca_file)
    meta = {
        "dit_cfg": dataclasses.asdict(models.dit_cfg),
        "dac_cfg": dataclasses.asdict(models.dac_cfg),
        "dtype": str(models.dtype).removeprefix("torch."),
        "dit_quant": "int8" if dit_is_quantized(models.dit) else "none",
    }
    with open(os.path.join(path, CONFIG), "w") as f:
        json.dump(meta, f, indent=2)


def _config(cls, fields: dict):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items()})


def load_checkpoint(path: str, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> EchoModels:
    """The bundle at `path` on `device`, with its own configs; the DiT in
    `dtype` (default: the bundle's; a W8A8 DiT's int8 weights and scales
    keep their types), the codec in the dtype it was saved in.  Raises
    without CUDA unless device='cpu'."""
    from safetensors.torch import load_file

    device = resolve_device(device)
    with open(os.path.join(path, CONFIG)) as f:
        meta = json.load(f)
    dit_cfg = _config(EchoDiTConfig, meta["dit_cfg"])
    dac_cfg = _config(DACConfig, meta["dac_cfg"])
    dtype = dtype or getattr(torch, meta["dtype"])
    dit_file, dac_file, pca_file = (os.path.join(path, f) for f in FILES)
    dac_state = load_file(dac_file)
    pca = load_file(pca_file)
    return EchoModels(
        dit=load_dit_state(load_file(dit_file), dit_cfg, device=device,
                           dtype=dtype),
        dac=load_dac_state(dac_state, dac_cfg, device=device,
                           dtype=next(iter(dac_state.values())).dtype),
        pca={"components": pca["components"].to(device),
             "mean": pca["mean"].to(device),
             "latent_scale": float(pca["latent_scale"][0])},
        dtype=dtype)
