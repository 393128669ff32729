"""Batched multi-request execution.

Counterpart of echo_tts_tpu/serve/batcher.py.  The reference serves one
request per worker (share-nothing RunPod workers, SURVEY.md §2e); here
compatible requests (same sampler parameters) are stacked along the batch
axis and run through ONE sampler pass and a sliced decode: the CFG x G
factor and the batch fold into one (G*B)-row DiT forward, so every weight
read serves B requests, and kernel A runs over a static K/V batch B with
GB = 3B rows on CFG steps.

Per-request seeds are kept: request i's starting noise is drawn from
torch.Generator(device).manual_seed(seed_i) with the shape and order that
pipeline.euler_sample_fn draws for a single request ((1, S, latent) in
fp32), so a request starts from the same noise, bit for bit, batched or
alone (the port's form of the JAX package's `_key_data` / `_draw_noise`,
which reproduce PRNGKey(seed) host-side).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MAX_TEXT_LENGTH, SAMPLER_DEFAULTS
from ..pipeline import dsp
from ..pipeline.pipeline import (EchoModels, ae_decode,
                                 get_speaker_latent_and_mask)
from ..pipeline.text import get_text_input_ids_and_mask
from ..sampler.euler import sample_euler_cfg_independent_guidances


@dataclasses.dataclass
class BatchRequest:
    text: str
    seed: int
    speaker_audio: Optional[np.ndarray] = None  # (1, samples) float32
    # Pre-encoded voice (1, T, 80): a serving voice-latent cache entry;
    # skips the per-request AE encode.  Mutually exclusive with
    # speaker_audio.  speaker_mask (1, T) carries the true length when the
    # latent is bucket-padded; defaults to all-True.
    speaker_latent: Optional[np.ndarray] = None
    speaker_mask: Optional[np.ndarray] = None
    request_id: Optional[str] = None


@dataclasses.dataclass
class BatchResult:
    audio: np.ndarray        # (1, samples) float32, flattening-cropped
    normalized_text: str
    request_id: Optional[str]


def _group_key(params: Dict) -> Tuple:
    return tuple(sorted(params.items()))


def draw_noise(seeds: Sequence[int], sequence_length: int, latent_size: int,
               device) -> torch.Tensor:
    """(B, sequence_length, latent_size) fp32 on `device`: row i is the
    starting noise euler_sample_fn draws for seed_i alone."""
    rows = []
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        rows.append(torch.randn((1, sequence_length, latent_size),
                                generator=gen, device=device,
                                dtype=torch.float32))
    return torch.cat(rows)


def group_compatible(requests: Sequence[Tuple[BatchRequest, Dict]],
                     max_batch: int) -> List[List[int]]:
    """Indices grouped by identical sampler params, split to max_batch."""
    by_key: Dict[Tuple, List[int]] = {}
    for i, (_, params) in enumerate(requests):
        by_key.setdefault(_group_key(params), []).append(i)
    groups: List[List[int]] = []
    for idxs in by_key.values():
        for j in range(0, len(idxs), max_batch):
            groups.append(idxs[j:j + max_batch])
    return groups


@torch.inference_mode()
def run_batch(
    models: EchoModels,
    requests: Sequence[BatchRequest],
    sampler_params: Optional[Dict] = None,
    speaker_bucket: Optional[int] = None,
    decode_batch: int = 4,
    initial_noise: Optional[torch.Tensor] = None,
) -> List[BatchResult]:
    """Execute one homogeneous batch (same sampler params for all).

    Speaker latents are padded to `speaker_bucket` (default: the longest
    in the batch, rounded up to the patch size) so that mixed-length
    references batch together; masks carry the true lengths.

    The sampler runs the whole batch in one (G*B)-row pass; the codec
    decodes in `decode_batch`-row slices, as the JAX package does (decode
    gains nothing from a larger batch, and its activations are large).
    `initial_noise` (B, S, latent) fp32 replaces the per-seed draw
    (`draw_noise`); the tests inject it.
    """
    if not requests:
        return []
    p = dict(SAMPLER_DEFAULTS)
    p.update(sampler_params or {})
    seq_len = p.pop("sequence_length")
    b = len(requests)
    cfg = models.dit_cfg
    ps = cfg.speaker_patch_size
    dev = models.device

    text_ids, text_mask, normalized = get_text_input_ids_and_mask(
        [r.text for r in requests], max_length=MAX_TEXT_LENGTH,
        return_normalized_text=True)

    # speaker latents -> one common bucket
    latents, masks = [], []
    for r in requests:
        if r.speaker_latent is not None:
            if r.speaker_audio is not None:
                raise ValueError(
                    "pass speaker_audio OR speaker_latent, not both")
            sl = np.asarray(r.speaker_latent, np.float32)
            latents.append(sl)
            masks.append(np.ones(sl.shape[:2], bool)
                         if r.speaker_mask is None
                         else np.asarray(r.speaker_mask, bool))
        elif r.speaker_audio is None:
            latents.append(np.zeros((1, ps, cfg.latent_size), np.float32))
            masks.append(np.zeros((1, ps), bool))
        else:
            sl, sm = get_speaker_latent_and_mask(models, r.speaker_audio)
            latents.append(sl)
            masks.append(sm)
    max_len = max(sl.shape[1] for sl in latents)
    bucket = speaker_bucket or -(-max_len // ps) * ps
    if any(sl.shape[1] > bucket for sl in latents):
        raise ValueError(f"speaker_bucket {bucket} smaller than a "
                         "reference in the batch")
    spk_lat = np.zeros((b, bucket, cfg.latent_size), np.float32)
    spk_mask = np.zeros((b, bucket), bool)
    for i, (sl, sm) in enumerate(zip(latents, masks)):
        spk_lat[i, :sl.shape[1]] = sl[0]
        spk_mask[i, :sm.shape[1]] = sm[0]

    if initial_noise is None:
        initial_noise = draw_noise([r.seed for r in requests], seq_len,
                                   cfg.latent_size, dev)
    elif tuple(initial_noise.shape) != (b, seq_len, cfg.latent_size):
        raise ValueError(f"initial_noise {tuple(initial_noise.shape)} must "
                         f"be {(b, seq_len, cfg.latent_size)}")

    latent_out = sample_euler_cfg_independent_guidances(
        models.dit, torch.from_numpy(spk_lat).to(dev),
        torch.from_numpy(spk_mask).to(dev), torch.from_numpy(text_ids).to(dev),
        torch.from_numpy(text_mask).to(dev), sequence_length=seq_len,
        dtype=models.dtype, initial_noise=initial_noise, **p)

    audio = np.concatenate(
        [ae_decode(models, latent_out[i:i + decode_batch]).cpu().numpy()
         for i in range(0, b, decode_batch)], axis=0)
    latents_host = latent_out.cpu().numpy()
    spl = models.dac_cfg.frame_length
    results = []
    for i, r in enumerate(requests):
        cropped = dsp.crop_audio_to_flattening_point(
            audio[i:i + 1], latents_host[i], samples_per_latent=spl)
        results.append(BatchResult(audio=cropped,
                                   normalized_text=normalized[i],
                                   request_id=r.request_id))
    return results
