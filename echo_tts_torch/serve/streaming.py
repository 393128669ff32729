"""Streaming synthesis: blockwise generation with incremental decode.

Counterpart of echo_tts_tpu/serve/streaming.py.  The reference's streaming
story is the blockwise sampler (inference_blockwise.py; README.md:95-102
chunk_size=160), which decodes the whole latent buffer at the end.  Here,
after each latent block the codec decodes just that block through a
carried decode state (models/dac/streaming.py) and the block's audio is
yielded; streamed audio equals the one-shot decode of the same latents up
to float reduction order.

Two designs of the JAX module change for an eager program:

  * its fused first block (one XLA program for the prefill, the
    latent-free first block and the first decode, to save dispatch round
    trips) is here the block iterator's own first block and its decode,
    which issue the same work in the same order with no host sync before
    the decode;
  * its drain order, which yields block i only after block i+1's sampler
    has been dispatched (a dispatch there costs milliseconds), would here
    hold every chunk back by a whole block, because running a block's
    step loop is the host's work: block i's audio is copied to the host
    and yielded, and only then does block i+1 run.  The chunks, their
    order and their contents are the JAX module's.

The JAX module carries the latent prefix (incremental_latent) only from
2560 latents, its crossover on the v5e.  On the H100 the eager sampler's
two forms cost the same at every stream length (host-bound launches;
tools/stream_checks.py), so this module carries it whenever the block
sizes allow, and the re-encode is the tests' reference.

`continuation_latent` is prepended to the prefix buffer for generation
resume (inference_blockwise.py:62-65); the decode state is warmed by
decoding the continuation first (its audio is not yielded).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..config import MAX_SPEAKER_LATENT_LENGTH, MAX_TEXT_LENGTH, SAMPLER_DEFAULTS
from ..models.dac.streaming import MAX_POSITIONS
from ..pipeline.pipeline import (EchoModels, ae_decode_block,
                                 ae_decode_stream_init,
                                 get_speaker_latent_and_mask)
from ..pipeline.text import get_text_input_ids_and_mask
from ..sampler import blockwise as bw

@dataclasses.dataclass
class StreamChunk:
    index: int
    audio: np.ndarray            # (1, samples) float32, this block only
    latent_start: int
    latent_end: int
    is_last: bool


@torch.inference_mode()
def stream_synthesize(
    models: EchoModels,
    text: str,
    speaker_audio: Optional[np.ndarray] = None,
    *,
    chunk_size: int = 160,       # reference: README.md:95-102
    num_chunks: int = 4,
    chunk_sizes: Optional[Sequence[int]] = None,
    seed: int = 0,
    sampler_params: Optional[Dict] = None,
    continuation_latent: Optional[np.ndarray] = None,
    speaker_bucket: Optional[int] = None,
    speaker_latent: Optional[np.ndarray] = None,
    speaker_mask: Optional[np.ndarray] = None,
) -> Iterator[StreamChunk]:
    """Yield audio block by block for one utterance (streaming.py:101-277).

    `chunk_sizes` overrides the uniform chunk_size * num_chunks schedule
    with an explicit list of block sizes, e.g. `growing_schedule(640)`
    ([40, 80, 160, 320, 40]), whose small first block brings first audio
    sooner.  The noise of every block is drawn in turn from one
    torch.Generator seeded with `seed` on the models' device."""
    p = dict(SAMPLER_DEFAULTS)
    p.update(sampler_params or {})
    p.pop("sequence_length", None)  # streaming length = the block sizes
    cfg = models.dit_cfg
    ps = cfg.speaker_patch_size

    if chunk_sizes is None:
        chunk_sizes = [chunk_size] * num_chunks
    chunk_sizes = [int(c) for c in chunk_sizes]
    if not chunk_sizes or min(chunk_sizes) <= 0:
        raise ValueError(f"chunk_sizes must be non-empty positive, got "
                         f"{chunk_sizes}")
    cont_len = 0 if continuation_latent is None else continuation_latent.shape[1]
    total = sum(chunk_sizes) + cont_len
    if total > MAX_POSITIONS:
        raise ValueError(
            f"stream of {total} latents exceeds the decode RoPE bound "
            f"{MAX_POSITIONS} (~{MAX_POSITIONS / 21.5 / 60:.1f} min)")

    text_ids, text_mask = get_text_input_ids_and_mask(
        [text], max_length=MAX_TEXT_LENGTH)
    if speaker_latent is not None:
        # a pre-encoded voice: no AE encode
        if speaker_audio is not None:
            raise ValueError("pass speaker_audio OR speaker_latent, not both")
        if speaker_mask is None:
            speaker_mask = np.ones(speaker_latent.shape[:2], bool)
    elif speaker_audio is None:
        speaker_latent = np.zeros((1, ps, cfg.latent_size), np.float32)
        speaker_mask = np.zeros((1, ps), bool)
    else:
        speaker_latent, speaker_mask = get_speaker_latent_and_mask(
            models, speaker_audio,
            max_speaker_latent_length=speaker_bucket or MAX_SPEAKER_LATENT_LENGTH,
            pad_to_max=speaker_bucket is not None)

    # each block's latent prefix encoded once and carried, wherever the
    # blocks lie on the patch grid; else re-encoded every block, as the
    # reference does (the latents are equal either way)
    use_inc = all(n % ps == 0 for n in [cont_len] + chunk_sizes[:-1])
    dev = models.device

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ids, tmask = on_device(text_ids), on_device(text_mask)
    spk, smask = on_device(speaker_latent), on_device(speaker_mask)
    cont = None if continuation_latent is None else on_device(continuation_latent)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    state = ae_decode_stream_init(models)
    if cont is not None:
        # the decode state sees the continuation, so the first generated
        # block decodes with its true causal context
        _, state = ae_decode_block(models, state, cont)
    blocks = bw.iter_blockwise_euler_cfg_independent_guidances(
        models.dit, spk, smask, ids, tmask, block_sizes=chunk_sizes,
        continuation_latent=cont, dtype=models.dtype, generator=gen,
        incremental_latent=use_inc, **p)
    for idx, (start, block, _prefix) in enumerate(blocks):
        audio, state = ae_decode_block(models, state, block)
        yield StreamChunk(index=idx, audio=audio.cpu().numpy(),
                          latent_start=start,
                          latent_end=start + chunk_sizes[idx],
                          is_last=idx == len(chunk_sizes) - 1)
