"""Text -> audio orchestration (host side).

Counterpart of echo_tts_tpu/pipeline/pipeline.py (reference:
inference.py:218-388): chunked AE encode of the speaker reference, the
sampler call, AE decode, the end-of-speech crop, the chunked-text
variant, and the streaming (block) encode/decode entry points.

A `sample_fn` has the signature
    sample_fn(models, speaker_latent, speaker_mask, text_ids, text_mask,
              rng_seed) -> latents (B, S, 80) float32
and is normally `functools.partial(euler_sample_fn, **SAMPLER_DEFAULTS)`.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import (DACConfig, EchoDiTConfig, MAX_SPEAKER_LATENT_LENGTH,
                      MAX_TEXT_LENGTH, base_dac_config, base_dit_config)
from ..device import resolve_device
from ..models.dac import dac as tdac
from ..models.dac import streaming as tstream
from ..models.dac.init import init_dac, init_pca_params
from ..models.dit import EchoDiT, init_dit
from ..sampler.euler import sample_euler_cfg_independent_guidances
from ..tools.bridge import load_dac_state, load_dit_state, pca_state
from . import dsp
from .text import chunk_text, get_text_input_ids_and_mask


@dataclasses.dataclass
class EchoModels:
    """The DiT, the codec and the PCA state (the analog of the reference's
    (model, fish_ae, pca_state) triple)."""
    dit: EchoDiT
    dac: tdac.S1DAC
    pca: dict
    dtype: torch.dtype = torch.bfloat16

    @property
    def dit_cfg(self) -> EchoDiTConfig:
        return self.dit.cfg

    @property
    def dac_cfg(self) -> DACConfig:
        return self.dac.cfg

    @property
    def device(self) -> torch.device:
        return next(self.dit.parameters()).device


SampleFn = Callable[..., torch.Tensor]


def _dac_dtype(models: EchoModels) -> torch.dtype:
    """Codec compute dtype = its parameter dtype (bf16 on the card, fp32 on
    the CPU, handler.py:345,381)."""
    return next(models.dac.parameters()).dtype


@torch.inference_mode()
def ae_encode(models: EchoModels, audio: torch.Tensor) -> torch.Tensor:
    """(B, L) or (B, L, 1) waveform -> (B, T, 80) whitened fp32 latents
    (reference: inference.py:218-224)."""
    if audio.ndim == 2:
        audio = audio[..., None]
    audio = audio.to(device=models.device, dtype=_dac_dtype(models))
    z_q = tdac.encode_zq(models.dac, audio)
    return tdac.pca_whiten(z_q.float(), models.pca)


@torch.inference_mode()
def ae_decode(models: EchoModels, latents: torch.Tensor) -> torch.Tensor:
    """(B, T, 80) latents -> (B, T*2048) fp32 waveform
    (reference: inference.py:227-229)."""
    z_q = tdac.pca_unwhiten(latents.to(models.device).float(), models.pca)
    audio = tdac.decode_zq(models.dac, z_q.to(_dac_dtype(models)))
    return audio[..., 0].float()


def ae_reconstruct(models: EchoModels, audio: torch.Tensor) -> torch.Tensor:
    """Debug round trip, ae_decode(ae_encode(audio)) (reference:
    inference.py:231-235)."""
    return ae_decode(models, ae_encode(models, audio))


@functools.lru_cache(maxsize=8)
def _decode_state_template(dac_cfg: DACConfig, batch: int, dtype: torch.dtype,
                           device: torch.device) -> dict:
    """The zero decode state, built once per (config, batch, dtype, device)
    (pipeline.py:106-116): dozens of small tensors that would otherwise be
    made at the start of every stream.  Block calls never write into a
    state they are given, so every stream shares it."""
    return tstream.init_decode_state(dac_cfg, batch, dtype, device)


def ae_decode_stream_init(models: EchoModels, batch: int = 1) -> dict:
    """Fresh incremental-decode state: the device state under "inner" and
    "pos", the stream's position in latents, kept on the host so that the
    RoPE-bound check needs no device sync."""
    return {"inner": _decode_state_template(models.dac_cfg, batch,
                                            _dac_dtype(models), models.device),
            "pos": 0}


@torch.inference_mode()
def ae_decode_block(models: EchoModels, state: dict, latents: torch.Tensor,
                    *, max_positions: Optional[int] = None):
    """Incremental ae_decode: (B, T_block, 80) latents -> ((B, T_block *
    2048) fp32 waveform, new state).  Consecutive blocks reproduce
    ae_decode of the concatenated latents (up to float reduction order)
    at O(block) cost (pipeline.py:182-203).  `max_positions` (default
    streaming.MAX_POSITIONS) bounds the RoPE positions of one stream;
    going past it raises."""
    if max_positions is None:
        max_positions = tstream.MAX_POSITIONS
    pos = state["pos"]
    if pos + latents.shape[1] > max_positions:
        raise ValueError(
            f"decode stream position {pos} + block {latents.shape[1]} "
            f"exceeds the RoPE bound {max_positions}; raise max_positions "
            "(consistently across the stream) for longer audio")
    z_q = tdac.pca_unwhiten(latents.to(models.device).float(), models.pca)
    audio, inner = tstream.decode_zq_block(
        models.dac, state["inner"], z_q.to(_dac_dtype(models)),
        max_positions=max_positions)
    return audio[..., 0].float(), {"inner": inner, "pos": pos + latents.shape[1]}


def ae_encode_stream_init(models: EchoModels, batch: int = 1) -> dict:
    """Fresh incremental-encode state; "pos" is the encoder-frame position,
    kept on the host."""
    return {"inner": tstream.init_encode_state(models.dac_cfg, batch,
                                               _dac_dtype(models),
                                               models.device),
            "pos": 0}


@torch.inference_mode()
def ae_encode_block(models: EchoModels, state: dict, audio: torch.Tensor,
                    *, max_positions: Optional[int] = None):
    """Incremental ae_encode: (B, L_block) or (B, L_block, 1) waveform,
    L_block a frame_length multiple -> ((B, L_block / 2048, 80) whitened
    fp32 latents, new state) (pipeline.py:140-173).  Consecutive blocks
    reproduce ae_encode of the concatenated audio.  The RoPE bound binds
    at the encoder-tail transformer, one position per hop_length samples
    (default streaming.MAX_ENC_POSITIONS); going past it raises."""
    if max_positions is None:
        max_positions = tstream.MAX_ENC_POSITIONS
    if audio.ndim == 2:
        audio = audio[..., None]
    cfg = models.dac_cfg
    frames = audio.shape[1] // cfg.hop_length
    pos = state["pos"]
    if pos + frames > max_positions:
        raise ValueError(
            f"encode stream position {pos} + block {frames} frames "
            f"exceeds the RoPE bound {max_positions} "
            f"(~{max_positions * cfg.hop_length / cfg.sample_rate:.0f}"
            " s of audio); raise max_positions consistently for longer")
    audio = audio.to(device=models.device, dtype=_dac_dtype(models))
    z_q, inner = tstream.encode_zq_block(models.dac, state["inner"], audio,
                                         max_positions=max_positions)
    return (tdac.pca_whiten(z_q.float(), models.pca),
            {"inner": inner, "pos": pos + frames})


def get_speaker_latent_and_mask(
    models: EchoModels,
    audio: np.ndarray,  # (1, length) float32
    max_speaker_latent_length: int = MAX_SPEAKER_LATENT_LENGTH,
    audio_chunk_size: Optional[int] = None,
    pad_to_max: bool = False,
    divis_by_patch_size: Optional[int] = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunked AE encode of the speaker reference (inference.py:239-283):
    chunks of 640 latents of audio, each zero-padded to the full chunk,
    then concatenated and cropped/padded."""
    assert audio.ndim == 2 and audio.shape[0] == 1
    spl = models.dac_cfg.frame_length  # samples per latent
    if audio_chunk_size is None:
        audio_chunk_size = 640 * spl
    audio = np.asarray(audio, dtype=np.float32)[:, :max_speaker_latent_length * spl]

    latent_arr = []
    for i in range(0, audio.shape[1], audio_chunk_size):
        chunk = audio[:, i:i + audio_chunk_size]
        if chunk.shape[1] < audio_chunk_size:
            chunk = np.pad(chunk, ((0, 0), (0, audio_chunk_size - chunk.shape[1])))
        latent = ae_encode(models, torch.from_numpy(chunk))
        latent_arr.append(latent.cpu().numpy())

    speaker_latent = np.concatenate(latent_arr, axis=1)
    actual = audio.shape[1] // spl
    speaker_mask = (np.arange(speaker_latent.shape[1]) < actual)[None, :]

    if pad_to_max and speaker_latent.shape[1] < max_speaker_latent_length:
        pad = max_speaker_latent_length - speaker_latent.shape[1]
        speaker_latent = np.pad(speaker_latent, ((0, 0), (0, pad), (0, 0)))
        speaker_mask = np.pad(speaker_mask, ((0, 0), (0, pad)))
    elif not pad_to_max:
        speaker_latent = speaker_latent[:, :actual]
        speaker_mask = speaker_mask[:, :actual]

    if divis_by_patch_size is not None:
        n = speaker_latent.shape[1] // divis_by_patch_size * divis_by_patch_size
        speaker_latent = speaker_latent[:, :n]
        speaker_mask = speaker_mask[:, :n]

    return speaker_latent.astype(np.float32), speaker_mask


def sample_pipeline(
    models: EchoModels,
    sample_fn: SampleFn,
    text_prompt: str,
    speaker_audio: Optional[np.ndarray],
    rng_seed: int,
    pad_to_max_speaker_latent_length: Optional[int] = None,
    pad_to_max_text_length: Optional[int] = None,
    normalize_text: bool = True,
    speaker_latent: Optional[np.ndarray] = None,
    speaker_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, str]:
    """Single-chunk text -> audio (inference.py:308-347).  Returns
    ((1, samples) float32, normalized_text).  A pre-encoded
    (speaker_latent, speaker_mask) pair skips the AE encode."""
    text_ids, text_mask, normalized = get_text_input_ids_and_mask(
        [text_prompt],
        max_length=min(pad_to_max_text_length or MAX_TEXT_LENGTH,
                       MAX_TEXT_LENGTH),
        normalize=normalize_text, return_normalized_text=True)

    if speaker_latent is not None:
        if speaker_audio is not None:
            raise ValueError("pass speaker_audio OR speaker_latent, not both")
        if speaker_mask is None:
            speaker_mask = np.ones(speaker_latent.shape[:2], bool)
    elif speaker_audio is None:
        n = pad_to_max_speaker_latent_length or 4
        speaker_latent = np.zeros((1, n, models.dit_cfg.latent_size),
                                  dtype=np.float32)
        speaker_mask = np.zeros((1, n), dtype=bool)
    else:
        speaker_latent, speaker_mask = get_speaker_latent_and_mask(
            models, speaker_audio,
            max_speaker_latent_length=(pad_to_max_speaker_latent_length
                                       or MAX_SPEAKER_LATENT_LENGTH),
            pad_to_max=pad_to_max_speaker_latent_length is not None)

    dev = models.device
    latent_out = sample_fn(
        models, torch.from_numpy(np.ascontiguousarray(speaker_latent)).to(dev),
        torch.from_numpy(np.ascontiguousarray(speaker_mask)).to(dev),
        torch.from_numpy(text_ids).to(dev), torch.from_numpy(text_mask).to(dev),
        rng_seed)

    audio_out = ae_decode(models, latent_out).cpu().numpy()
    audio_out = dsp.crop_audio_to_flattening_point(
        audio_out, latent_out[0].cpu().numpy(),
        samples_per_latent=models.dac_cfg.frame_length)
    return audio_out, normalized[0]


def sample_pipeline_chunked(
    models: EchoModels,
    sample_fn: SampleFn,
    text_prompt: str,
    speaker_audio: Optional[np.ndarray],
    rng_seed: int,
    *,
    max_chars_per_chunk: int = 300,
    pad_to_max_speaker_latent_length: Optional[int] = None,
    pad_to_max_text_length: Optional[int] = None,
    normalize_text: bool = True,
) -> Tuple[np.ndarray, str]:
    """Chunked variant with per-chunk seeds seed+idx and plain
    concatenation (inference.py:349-388); the speaker reference is encoded
    once and reused across chunks."""
    chunks = chunk_text(text_prompt, max_chars=max_chars_per_chunk)
    if not chunks:
        raise ValueError("text_prompt is empty after normalization")

    speaker_latent = speaker_mask = None
    if speaker_audio is not None:
        speaker_latent, speaker_mask = get_speaker_latent_and_mask(
            models, speaker_audio,
            max_speaker_latent_length=(pad_to_max_speaker_latent_length
                                       or MAX_SPEAKER_LATENT_LENGTH),
            pad_to_max=pad_to_max_speaker_latent_length is not None)

    audio_chunks: List[np.ndarray] = []
    normalized_chunks: List[str] = []
    for idx, chunk in enumerate(chunks):
        audio_out, normalized = sample_pipeline(
            models, sample_fn, chunk, None, rng_seed + idx,
            pad_to_max_speaker_latent_length=pad_to_max_speaker_latent_length,
            pad_to_max_text_length=pad_to_max_text_length,
            normalize_text=normalize_text,
            speaker_latent=speaker_latent, speaker_mask=speaker_mask)
        audio_chunks.append(audio_out)
        normalized_chunks.append(normalized)

    return (np.concatenate(audio_chunks, axis=-1),
            "\n".join(normalized_chunks))


def euler_sample_fn(models: EchoModels, speaker_latent: torch.Tensor,
                    speaker_mask: torch.Tensor, text_ids: torch.Tensor,
                    text_mask: torch.Tensor, rng_seed: int,
                    **sampler_kwargs) -> torch.Tensor:
    """The Euler sampler as a `sample_fn`: the starting noise comes from a
    torch.Generator on the models' device seeded with rng_seed (the JAX
    package's PRNGKey(rng_seed)); build it with functools.partial over the
    sampler parameters (handler.py:426-443)."""
    gen = torch.Generator(device=models.device).manual_seed(int(rng_seed))
    return sample_euler_cfg_independent_guidances(
        models.dit, speaker_latent, speaker_mask, text_ids, text_mask,
        dtype=models.dtype, generator=gen, **sampler_kwargs)


# The published checkpoint's files (serve/models.py:29-31 of the JAX package)
DIT_WEIGHTS = "pytorch_model.safetensors"
DAC_WEIGHTS = "fish_ae.safetensors"
PCA_WEIGHTS = "pca_state.safetensors"


def _codec_setup(device: torch.device, dac_cfg: Optional[DACConfig]
                 ) -> Tuple[DACConfig, torch.dtype]:
    """The serving codec (serve/models.py:34-50,103-106): bf16 with the
    decoder's polynomial snake on the card, fp32 with exact sin on the
    CPU, unless `dac_cfg` says otherwise."""
    on_card = device.type == "cuda"
    if dac_cfg is None:
        dac_cfg = dataclasses.replace(base_dac_config(), snake_approx=on_card)
    return dac_cfg, torch.bfloat16 if on_card else torch.float32


def load_models_from_dir(model_dir: str, device="cuda", dtype=torch.bfloat16,
                         *, dit_cfg: Optional[EchoDiTConfig] = None,
                         dac_cfg: Optional[DACConfig] = None) -> EchoModels:
    """The published safetensors in `model_dir` (the layout of the JAX
    package's serve/models.py:_load_from_dir), loaded under their own keys.
    Raises without CUDA unless device='cpu'."""
    return load_models_from_files(
        os.path.join(model_dir, DIT_WEIGHTS),
        os.path.join(model_dir, DAC_WEIGHTS),
        os.path.join(model_dir, PCA_WEIGHTS), device, dtype,
        dit_cfg=dit_cfg, dac_cfg=dac_cfg)


def load_models_from_files(dit_path: str, dac_path: str, pca_path: str,
                           device="cuda", dtype=torch.bfloat16, *,
                           dit_cfg: Optional[EchoDiTConfig] = None,
                           dac_cfg: Optional[DACConfig] = None,
                           dac_dtype: Optional[torch.dtype] = None
                           ) -> EchoModels:
    """The published DiT, codec and PCA safetensors at these paths; the
    codec in the serving setting (`_codec_setup`) unless `dac_cfg` or
    `dac_dtype` say otherwise.  Raises without CUDA unless device='cpu'."""
    from safetensors.torch import load_file

    device = resolve_device(device)
    dit_cfg = dit_cfg or base_dit_config()
    dac_cfg, default_dac_dtype = _codec_setup(device, dac_cfg)
    pca = load_file(pca_path)
    return EchoModels(
        dit=load_dit_state(load_file(dit_path), dit_cfg, device=device,
                           dtype=dtype),
        dac=load_dac_state(load_file(dac_path), dac_cfg, device=device,
                           dtype=dac_dtype or default_dac_dtype),
        pca=pca_state({"components": pca["pca_components"].float().numpy(),
                       "mean": pca["pca_mean"].float().numpy(),
                       "latent_scale": pca["latent_scale"].float().numpy()},
                      device=device),
        dtype=dtype)


def random_models(device="cuda", dtype=torch.bfloat16, seed: int = 0, *,
                  dit_cfg: Optional[EchoDiTConfig] = None,
                  dac_cfg: Optional[DACConfig] = None) -> EchoModels:
    """Seeded random-weight models at the published width (counterpart of
    serve/models.py:126-140).  On the card the codec is bf16 with the
    decoder's polynomial snake, the serving setting; on the CPU it is fp32
    with exact sin.  Raises without CUDA unless device='cpu'."""
    device = resolve_device(device)
    dit_cfg = dit_cfg or base_dit_config()
    dac_cfg, dac_dtype = _codec_setup(device, dac_cfg)
    return EchoModels(
        dit=init_dit(dit_cfg, device=device, dtype=dtype, seed=seed),
        dac=init_dac(dac_cfg, device=device, dtype=dac_dtype, seed=seed + 1),
        pca=init_pca_params(dit_cfg.latent_size, dac_cfg.latent_dim,
                            device=device, seed=seed + 2),
        dtype=dtype)
