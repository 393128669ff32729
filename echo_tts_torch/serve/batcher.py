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

A pass's host stages are spans (utils/profiling.py), children of the
server's `server.pass` or roots when run_batch is called alone:
`batch.text`, `batch.speaker`, `batch.noise`, `batch.sampler` (the host's
enqueue of the captured sampler), `batch.decode` per decode slice (its
`rows`; the slice's audio copied to the host inside it), `batch.to_host`
(the slices' audio joined, the latents copied) and `batch.crop`.  The pass's shapes go on the innermost
open span (`profiling.annotate`): `rows` with padding, `seq`, the text
and speaker widths as launched, each row's real text and speaker
lengths, and the decode batches, read from the host's masks.

A Dia bundle (models/dia.DiaModels) runs the same entry: its requests'
texts (each voice prompt's transcript before the text) and prompt codes
in one pass through the encoder (`dia.encode`: `rows`, `text_width`,
`text_lengths`), the prompts' prefill (`dia.prefill`: `rows`,
`prompt_frames`), the frame loop (`dia.decode`: `rows`, `steps`,
`cache_capacity`, `frames`; sampler/ar.py), the delay undone and the
codes copied (`dia.codes`), then the codec's decode in `decode_batch`
slices (`batch.decode`), each request at its own length.  Each of the
first three ends with the card's work done, so that the device time of a
stage lies inside its span.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DIA_SAMPLER_DEFAULTS, MAX_TEXT_LENGTH, SAMPLER_DEFAULTS
from ..models import dia
from ..models.dac.dac import dac44_decode_codes
from ..pipeline import dsp
from ..pipeline.pipeline import (EchoModels, ae_decode,
                                 get_speaker_latent_and_mask)
from ..pipeline.text import dia_text_ids, get_text_input_ids_and_mask
from ..sampler import ar
from ..sampler.euler import sample_euler_cfg_independent_guidances
from ..utils import profiling


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
    # Dia: the voice prompt's codes (P, channels) and its transcript (put
    # before `text`), the frames to generate, and whether the result
    # carries the request's logits (DiaModels.keep_logits slots a pass)
    prompt_codes: Optional[np.ndarray] = None
    prompt_text: str = ""
    frames: Optional[int] = None
    keep_logits: bool = False


@dataclasses.dataclass
class BatchResult:
    audio: np.ndarray        # (1, samples) float32, flattening-cropped
    normalized_text: str
    request_id: Optional[str]
    # Dia: the generated frames' codes (frames, channels), and with
    # keep_logits the conditional and unconditional logits of every step,
    # (2, frames + max delay, channels, vocab) fp32 on the device
    codes: Optional[np.ndarray] = None
    logits: Optional[torch.Tensor] = None


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
    if isinstance(models, dia.DiaModels):
        return _run_dia_batch(models, requests, sampler_params, decode_batch)
    p = dict(SAMPLER_DEFAULTS)
    p.update(sampler_params or {})
    seq_len = p.pop("sequence_length")
    b = len(requests)
    cfg = models.dit_cfg
    ps = cfg.speaker_patch_size
    dev = models.device

    with profiling.span("batch.text"):
        text_ids, text_mask, normalized = get_text_input_ids_and_mask(
            [r.text for r in requests], max_length=MAX_TEXT_LENGTH,
            return_normalized_text=True)

    # speaker latents -> one common bucket
    with profiling.span("batch.speaker"):
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
                latents.append(np.zeros((1, ps, cfg.latent_size),
                                        np.float32))
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

    with profiling.span("batch.noise"):
        if initial_noise is None:
            initial_noise = draw_noise([r.seed for r in requests], seq_len,
                                       cfg.latent_size, dev)
        elif tuple(initial_noise.shape) != (b, seq_len, cfg.latent_size):
            raise ValueError(f"initial_noise {tuple(initial_noise.shape)} "
                             f"must be {(b, seq_len, cfg.latent_size)}")

    slices = range(0, b, decode_batch)
    profiling.annotate(
        rows=b, seq=seq_len, text_width=int(text_mask.shape[1]),
        speaker_width=bucket, text_lengths=text_mask.sum(1).tolist(),
        speaker_lengths=spk_mask.sum(1).tolist(),
        decode_batches=[min(decode_batch, b - i) for i in slices])
    with profiling.span("batch.sampler"):
        latent_out = sample_euler_cfg_independent_guidances(
            models.dit, torch.from_numpy(spk_lat).to(dev),
            torch.from_numpy(spk_mask).to(dev),
            torch.from_numpy(text_ids).to(dev),
            torch.from_numpy(text_mask).to(dev), sequence_length=seq_len,
            dtype=models.dtype, initial_noise=initial_noise, **p)

    audio = []
    for i in slices:
        with profiling.span("batch.decode", rows=min(decode_batch, b - i)):
            audio.append(ae_decode(
                models, latent_out[i:i + decode_batch]).cpu().numpy())
    with profiling.span("batch.to_host"):
        audio = np.concatenate(audio, axis=0)
        latents_host = latent_out.cpu().numpy()
    spl = models.dac_cfg.frame_length
    results = []
    with profiling.span("batch.crop"):
        for i, r in enumerate(requests):
            cropped = dsp.crop_audio_to_flattening_point(
                audio[i:i + 1], latents_host[i], samples_per_latent=spl)
            results.append(BatchResult(audio=cropped,
                                       normalized_text=normalized[i],
                                       request_id=r.request_id))
    return results


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_dia_batch(models: dia.DiaModels, requests: Sequence[BatchRequest],
                   sampler_params: Optional[Dict],
                   decode_batch: int) -> List[BatchResult]:
    """A Dia pass (module docstring): B requests, 2B model rows."""
    cfg, dev, b = models.cfg, models.device, len(requests)
    p = dict(DIA_SAMPLER_DEFAULTS)
    p.update(sampler_params or {})
    params = ar.SamplerParams(**p)
    if any(r.frames is None or r.frames < 1 for r in requests):
        raise ValueError("a Dia request gives the frames to generate")
    frames = [int(r.frames) for r in requests]
    # the server pads a pass with repeats of its last request: one slot each
    keep = [i for i, r in enumerate(requests) if r.keep_logits
            and all(q is not r for q in requests[:i])]

    with profiling.span("batch.text"):
        texts = [r.prompt_text + r.text for r in requests]
        ids = dia_text_ids(texts, cfg.text_length, cfg.text_pad_value)
        valid = ids != cfg.text_pad_value
        prompts = [np.zeros((0, cfg.channels), np.int64)
                   if r.prompt_codes is None
                   else np.asarray(r.prompt_codes, np.int64).reshape(
                       -1, cfg.channels) for r in requests]
        p_frames = [int(x.shape[0]) for x in prompts]
    st = ar.state_for(models.dia, b, models.keep_logits, models.dtype,
                      params)
    steps = ar.begin(st, prompts, frames, [r.seed for r in requests], keep,
                     cfg)

    with profiling.span("dia.encode", rows=2 * b, text_width=cfg.text_length,
                        text_lengths=valid.sum(1).tolist()):
        ids_t = torch.from_numpy(ids).to(dev)
        valid_t = torch.from_numpy(valid).to(dev)
        st.text_valid.copy_(torch.cat([valid_t, valid_t]))
        enc = dia.encode(models.dia, torch.cat([ids_t, torch.zeros_like(
            ids_t)]), st.text_valid)
        dia.cross_kv(models.dia, enc, st.k_cross, st.v_cross)
        del enc
        _sync(dev)
    with profiling.span("dia.prefill", rows=2 * b, prompt_frames=p_frames):
        ar.run_prefill(models.dia, st, max(p_frames))
        _sync(dev)
    with profiling.span("dia.decode", rows=2 * b, steps=steps,
                        cache_capacity=st.capacity, attn_bucket=st.bucket,
                        frames=frames):
        ar.generate(models.dia, st, steps, max(p_frames), params)
        _sync(dev)
    with profiling.span("dia.codes"):
        codes = ar.undelay(st.tokens, st.start, max(frames), st.delay)
        codes_host = codes.cpu().numpy()
        logits = {i: st.keep_logits[k, :, :frames[i] + cfg.max_delay].clone()
                  for k, i in enumerate(keep)}

    hop = models.dac_cfg.hop_length
    audio: List[np.ndarray] = []
    for i in range(0, b, decode_batch):
        n = min(decode_batch, b - i)
        with profiling.span("batch.decode", rows=n):
            width = max(frames[i:i + n])
            lens = torch.tensor(frames[i:i + n], device=dev)
            out = dac44_decode_codes(
                models.dac, codes[i:i + n, :width].transpose(1, 2), lens)
            audio.extend(out.cpu().numpy())
    with profiling.span("batch.crop"):
        return [BatchResult(audio=audio[i][None, :frames[i] * hop],
                            normalized_text=texts[i],
                            request_id=r.request_id,
                            codes=codes_host[i, :frames[i]],
                            logits=logits.get(i))
                for i, r in enumerate(requests)]
