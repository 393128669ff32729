"""Loading and caching the model bundle for serving.

Counterpart of echo_tts_tpu/serve/models.py.  The bundle is an
`EchoModels` from `model_dir`, which holds either the port's own
checkpoint bundle (tools/checkpoint.py: a distilled student, or any model
trained here, with its own configs) or the published safetensors
(`pipeline.load_models_from_dir`); or, for development and tests, seeded
random weights (`pipeline.random_models`).  ECHO_DIT_QUANT=int8 serves the
W8A8 DiT (`ops.quant.quantize_dit`): the mode changes only the modules,
never a code path downstream.  The codec's decoder snake follows the
device unless ECHO_SNAKE_APPROX says otherwise (`_serving_dac_config`);
a bundle keeps the snake it was saved with.

`architecture="dia"` serves Dia-1.6B instead (models/dia.py DiaModels:
the encoder-decoder, Descript's DAC 44 kHz, the frame loop of
sampler/ar.py), through the same server and run_batch.  Only its seeded
random weights exist here (`allow_random=True`): the loader of the
published Dia and DAC safetensors waits until those files are in the
repository.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Optional

import torch

from ..config import DACConfig, base_dac_config
from ..device import resolve_device
from ..ops.quant import dit_is_quantized, quantize_dit
from ..pipeline.pipeline import EchoModels, load_models_from_dir, random_models
from ..tools.checkpoint import is_bundle, load_checkpoint

log = logging.getLogger("echo_tts_torch.serve")

_CACHE_LOCK = threading.Lock()
_MODELS: Optional[EchoModels] = None
# (architecture, model_dir, dtype, random, quant_mode, device, snake)
_MODELS_KEY = None
ARCHITECTURES = ("echo", "dia")


def _serving_dac_config(device: torch.device) -> DACConfig:
    """base_dac_config with the decoder's polynomial snake exactly when the
    codec runs bf16, on the card (serve/models.py:34-50): its error is far
    below bf16 rounding; on the CPU the codec is fp32 and keeps exact sin.
    ECHO_SNAKE_APPROX=0/1 overrides the choice."""
    env = os.environ.get("ECHO_SNAKE_APPROX")
    if env is None:
        approx = device.type == "cuda"
    else:
        approx = env.lower() in ("1", "true", "yes")
    return dataclasses.replace(base_dac_config(), snake_approx=approx)


def _dit_quant_mode() -> str:
    """ECHO_DIT_QUANT: 'none' (default, the reference's bf16) or 'int8'
    (the W8A8 DiT, a non-parity mode); anything else raises."""
    mode = os.environ.get("ECHO_DIT_QUANT", "none").lower()
    if mode in ("", "0", "none", "bf16"):
        return "none"
    if mode == "int8":
        return "int8"
    raise ValueError(f"ECHO_DIT_QUANT={mode!r}: expected 'none' or 'int8'")


def load_models(model_dir: Optional[str] = None, device="cuda",
                dtype=torch.bfloat16, allow_random: bool = False,
                architecture: str = "echo"):
    """Load (once) and cache the model bundle (reference:
    handler.py:323-423): an EchoModels, or with architecture="dia" a
    DiaModels.  A later call that asks for another architecture,
    directory, dtype, quant mode, device or decoder snake raises rather
    than serve the cached bundle; call clear_models() to swap.  Raises
    without CUDA unless device='cpu'."""
    global _MODELS, _MODELS_KEY
    if architecture not in ARCHITECTURES:
        raise ValueError(f"architecture {architecture!r}: expected one of "
                         f"{ARCHITECTURES}")
    device = resolve_device(device)
    use_random = not (model_dir and os.path.isdir(model_dir))
    quant_mode = _dit_quant_mode()
    dac_cfg = _serving_dac_config(device)
    key = (architecture, None if use_random else model_dir, str(dtype),
           use_random, quant_mode, str(device), dac_cfg.snake_approx)
    with _CACHE_LOCK:
        if _MODELS is not None:
            if key != _MODELS_KEY:
                raise RuntimeError(
                    f"models already loaded with {_MODELS_KEY}; refusing to "
                    f"serve them for {key}: call clear_models() first")
            return _MODELS
        t0 = time.time()
        if architecture == "dia":
            models = _load_dia(model_dir, use_random, allow_random, device,
                               dtype, dac_cfg.snake_approx, quant_mode)
            _MODELS, _MODELS_KEY = models, key
            log.info("models ready in %.1fs", time.time() - t0)
            return _MODELS
        if not use_random and is_bundle(model_dir):
            models = load_checkpoint(model_dir, device, dtype)
            log.info("loaded the checkpoint bundle in %.1fs", time.time() - t0)
        elif not use_random:
            models = load_models_from_dir(model_dir, device, dtype,
                                          dac_cfg=dac_cfg)
        elif allow_random:
            log.warning("no model directory: using RANDOM weights (dev mode)")
            models = random_models(device, dtype, dac_cfg=dac_cfg)
        else:
            raise FileNotFoundError(
                f"model dir not found: {model_dir!r}; pass a directory with "
                "the published safetensors, or allow_random=True for "
                "development")
        if quant_mode == "int8":
            log.warning("ECHO_DIT_QUANT=int8: serving the W8A8 DiT "
                        "(non-parity mode)")
            models = dataclasses.replace(models, dit=quantize_dit(models.dit))
        _MODELS, _MODELS_KEY = models, key
        log.info("models ready in %.1fs", time.time() - t0)
        return _MODELS


def _load_dia(model_dir, use_random: bool, allow_random: bool, device,
              dtype, snake_approx: bool, quant_mode: str):
    """The Dia bundle: seeded random weights in the development mode; the
    published weights' loader waits for the files (module docstring)."""
    from ..config import dac44k_config
    from ..models.dia import random_dia_models
    if quant_mode != "none":
        raise ValueError("Dia serves bf16 only (ECHO_DIT_QUANT must be "
                         "'none')")
    if not use_random:
        raise NotImplementedError(
            "the loader of Dia's and DAC's published safetensors waits until "
            "those files are in the repository; serve random weights with "
            "allow_random=True")
    if not allow_random:
        raise FileNotFoundError(
            f"model dir not found: {model_dir!r}; Dia serves random weights "
            "with allow_random=True")
    log.warning("Dia with RANDOM weights (dev mode)")
    return random_dia_models(device, dtype,
                             dac_cfg=dac44k_config(snake_approx=snake_approx))


def models_loaded() -> bool:
    return _MODELS is not None


def served_quant_mode() -> str:
    """The quant mode of the DiT being served: read from the loaded modules
    when a bundle is loaded (the variable may have changed since), else
    from ECHO_DIT_QUANT."""
    with _CACHE_LOCK:
        m = _MODELS
    if m is None:
        return _dit_quant_mode()
    if not isinstance(m, EchoModels):
        return "none"                   # Dia serves bf16 only
    return "int8" if dit_is_quantized(m.dit) else "none"


def clear_models() -> None:
    global _MODELS, _MODELS_KEY
    with _CACHE_LOCK:
        _MODELS = None
        _MODELS_KEY = None
    # voice latents are valid only for the encoder that made them, and a
    # freed bundle's id() may be reused by the next one: the voice cache
    # must not outlive the bundle
    from . import handler as _handler
    _handler.clear_voice_cache()
