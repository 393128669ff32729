"""Streaming synthesis: blockwise generation with incremental decode.

Counterpart of echo_tts_tpu/serve/streaming.py.  The reference's streaming
story is the blockwise sampler (inference_blockwise.py; README.md:95-102
chunk_size=160), which decodes the whole latent buffer at the end.  Here,
after each latent block the codec decodes just that block through a
carried decode state (models/dac/streaming.py) and the block's audio is
yielded; streamed audio equals the one-shot decode of the same latents up
to float reduction order.

The stream runs as captured programs (utils/programs.py), one CUDA graph
per key and shape on a card:

  * a fresh stream's first audio is one program, `_fused_first_core`
    (streaming.py:57-98): the text and speaker prefill, the latent-free
    first block and its incremental decode, whose K/V and decode state
    come out as outputs, from which the block iterator continues the
    stream (`prefill_kv`, `first_block_latents`);
  * every later block is the iterator's block program (one per total
    bucket and block size, its start an input tensor), the carried
    prefix's append and the block decode (pipeline._decode_block_core);
  * the prefix buffer is padded to the stream-total bucket
    (presets.pick_stream_total_bucket, streaming.py:191-194), so that
    streams of one bucket share their programs.

The first block's noise is an input of the fused program, drawn from the
stream's generator before it, where the JAX program draws it inside: the
port draws every block's noise from one torch.Generator in block order,
the torch reference's order, so a stream's chunks are those of the
unfused iterator.

The drain is pipelined (streaming.py:240-277).  The first chunk is
yielded before the iterator advances.  After that, block i's audio is
copied to pinned host memory without blocking, behind an event, before
block i+1's programs are replayed, and chunk i is yielded once its event
has completed: the host then waits for block i's copy, not for block
i+1, whose programs the card runs meanwhile, so that the chunks arrive
one block apart, the first later block and the last included
(examples/soak_long_stream.py's block table; PERF.md section 5).  The
chunks, their order and their contents are the JAX module's.

The JAX module carries the latent prefix (incremental_latent) only from
2560 latents, its crossover on the v5e.  On the H100 no such crossover
shows (NVIDIA H100 80GB HBM3, 700.00 W).  The prefix work alone, per
stream, as the programs a stream replays, the buffer padded to the
stream's total bucket, tools/stream_checks.py --prefix 640 3840 (device:
the kernel intervals torch.profiler records; host: medians of five
streams, in turns, a synchronise around each call):

    total   device ms re-encode / carried   host ms re-encode / carried
      640     14.39 /  13.51  (0.94)           16.54 /  15.86
     3840    133.18 /  57.28  (0.43)          143.64 /  67.60

The carried form costs less at both lengths, on the card and on the host
(before the programs, run eagerly, it cost the card 0.90 to 0.40 of the
re-encode from 640 to 3840 latents, and the host time of both forms lay
within one run-to-run range).  So this module carries the prefix
wherever the block sizes allow, at every length, and the re-encode is
the tests' reference.

`continuation_latent` is prepended to the prefix buffer for generation
resume (inference_blockwise.py:62-65); the decode state is warmed by
decoding the continuation first (its audio is not yielded).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..config import MAX_SPEAKER_LATENT_LENGTH, MAX_TEXT_LENGTH, SAMPLER_DEFAULTS
from ..models.dac.streaming import MAX_POSITIONS
from ..pipeline import pipeline as pl
from ..pipeline.pipeline import (EchoModels, ae_decode_block,
                                 ae_decode_stream_init,
                                 get_speaker_latent_and_mask)
from ..pipeline.text import get_text_input_ids_and_mask
from ..sampler import blockwise as bw
from ..utils import programs
from .presets import pick_stream_total_bucket

@dataclasses.dataclass
class StreamChunk:
    index: int
    audio: np.ndarray            # (1, samples) float32, this block only
    latent_start: int
    latent_end: int
    is_last: bool


# The fused first-block programs, per models, block size, sampler statics
# and decode bound and per input shapes, at most 16: the bound of the JAX
# package's lru_cache on _fused_first_core.
FUSED_FIRST_PROGRAMS = programs.ProgramCache("fused_first", 16)


def _fused_first_body(models, text_ids, text_mask, speaker_latent,
                      speaker_mask, noise, dec_inner, *, first_block, dtype,
                      pca, dac_dtype, max_positions):
    kv_text, kv_speaker = bw._prefill_body(models.dit, text_ids, text_mask,
                                           speaker_latent, dtype=dtype)
    x_t = first_block(models.dit, noise, kv_text, kv_speaker, text_mask,
                      speaker_mask)
    audio, dec_inner = pl._decode_block_body(
        models.dac, dec_inner, x_t, pca=pca, dtype=dac_dtype,
        max_positions=max_positions)
    return audio, x_t, kv_text, kv_speaker, dec_inner


def _fused_first_core(models: EchoModels, block_size: int, statics: tuple,
                      max_positions: int):
    """run(text_ids, text_mask, speaker_latent fp32, speaker_mask, noise,
    dec_inner) -> (audio (B, block_size * 2048) fp32, the block's latents,
    kv_text, kv_speaker, the new decode inner state): the stream's first
    audio as one FUSED_FIRST_PROGRAMS program (streaming.py:57-98), the
    same bodies as the prefill, the first-block and the block-decode
    programs, so that fused and unfused streams agree.  Its owner is
    `models`, whose DiT and codec its graph reads."""
    dtype, dac_dtype = statics[-1], pl._dac_dtype(models)
    key = (models.dit_cfg, models.dac_cfg, block_size, statics, dac_dtype,
           max_positions)
    device = models.device

    def make_body():
        return functools.partial(
            _fused_first_body,
            first_block=bw.block_body(models.dit_cfg, block_size, block_size,
                                      statics, False, True, device),
            dtype=dtype, pca=models.pca, dac_dtype=dac_dtype,
            max_positions=max_positions)

    def run(*inputs):
        with torch.inference_mode():
            return FUSED_FIRST_PROGRAMS(key, models, list(inputs), make_body)
    return run


def _to_host(audio: torch.Tensor):
    """Start audio's copy to the host: on a card into pinned memory,
    without blocking, behind an event.  _host_array finishes it."""
    if audio.device.type != "cuda":
        return audio, None
    host = torch.empty(audio.shape, dtype=audio.dtype, pin_memory=True)
    host.copy_(audio, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_array(copy) -> np.ndarray:
    host, done = copy
    if done is not None:
        done.synchronize()
    return host.numpy()


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
    total_bucket: Optional[int] = None,
) -> Iterator[StreamChunk]:
    """Yield audio block by block for one utterance (streaming.py:101-277).

    `chunk_sizes` overrides the uniform chunk_size * num_chunks schedule
    with an explicit list of block sizes, e.g. `growing_schedule(640)`
    ([40, 80, 160, 320, 40]), whose small first block brings first audio
    sooner.  The noise of every block is drawn in turn from one
    torch.Generator seeded with `seed` on the models' device.
    `total_bucket`, the length the prefix buffer is padded to, defaults
    to presets.pick_stream_total_bucket of the stream's total (none past
    the largest bucket); the warm-up passes its manifest entry's."""
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
    if total_bucket is None:
        total_bucket = pick_stream_total_bucket(total)
        if total_bucket is not None and total_bucket % ps != 0:
            total_bucket = None
    dev = models.device

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ids, tmask = on_device(text_ids), on_device(text_mask)
    spk, smask = on_device(speaker_latent), on_device(speaker_mask)
    cont = None if continuation_latent is None else on_device(continuation_latent)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    state = ae_decode_stream_init(models)
    n_blocks = len(chunk_sizes)
    prefill_kv = first_latents = first_audio = None
    if cont is None:
        # prefill, first block and first decode as one program; its K/V
        # and decode state carry the rest of the stream
        statics = bw.sampler_statics(dtype=models.dtype, **p)
        noise0 = torch.randn((1, chunk_sizes[0], cfg.latent_size),
                             generator=gen, device=dev, dtype=torch.float32)
        first_audio, first_latents, kv_text, kv_speaker, inner = (
            _fused_first_core(models, chunk_sizes[0], statics, MAX_POSITIONS)(
                ids, tmask, spk.float(), smask, noise0, state["inner"]))
        state = {"inner": inner, "pos": chunk_sizes[0]}
        prefill_kv = (kv_text, kv_speaker)
    else:
        # the decode state sees the continuation, so the first generated
        # block decodes with its true causal context
        _, state = ae_decode_block(models, state, cont)
    blocks = bw.iter_blockwise_euler_cfg_independent_guidances(
        models.dit, spk, smask, ids, tmask, block_sizes=chunk_sizes,
        continuation_latent=cont, dtype=models.dtype, generator=gen,
        incremental_latent=use_inc, total_len_bucket=total_bucket,
        prefill_kv=prefill_kv, first_block_latents=first_latents, **p)

    def chunk(idx, start, copy):
        return StreamChunk(index=idx, audio=_host_array(copy),
                           latent_start=start,
                           latent_end=start + chunk_sizes[idx],
                           is_last=idx == n_blocks - 1)

    if first_audio is not None:
        # first audio leaves before the iterator advances
        yield chunk(0, 0, _to_host(first_audio))
    pending = None
    for idx, (start, block, _prefix) in enumerate(blocks):
        if idx == 0 and first_audio is not None:
            continue                    # yielded above
        audio, state = ae_decode_block(models, state, block)
        copy = (idx, start, _to_host(audio))
        if pending is not None:
            yield chunk(*pending)
        pending = copy
        if idx == 0:
            yield chunk(*pending)
            pending = None
    if pending is not None:
        yield chunk(*pending)
