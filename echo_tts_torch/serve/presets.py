"""Sampler presets, the shape buckets, the streaming block schedules and
the warm-up manifest.

Counterpart of echo_tts_tpu/serve/presets.py.  Presets mirror the
reference's sampler_presets.json (6 presets varying CFG scales,
truncation and temporal rescale; reference: sampler_presets.json:1-62,
loaded at gradio_app.py:431-451); a copy of the JSON ships with this
package.

The buckets keep the set of captured programs finite, as they keep the
JAX package's set of compiled programs finite: every sampler and codec
program is one CUDA graph per static key and input shapes
(utils/programs.py).  Text {768}, speaker {640, 2816, 6400} latents, the
sequence buckets of `auto_sequence_length`, the streaming block sizes and
stream-total buckets, and the micro-batch server's batch sizes
(`batch_size_buckets`, `pick_batch_bucket`).  `warmup_manifest` lists
every shape the serving surface accepts, from the same constants request
validation uses, and serve/handler.warmup_compile captures them before
traffic arrives.  The blockwise sampler's and the streaming path's
programs (with the JAX package's `total_len_bucket`) come with the
blockwise and streaming cores; until then their manifest entries run the
streams eagerly.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Tuple

from ..pipeline.text import find_min_bucket_gte

PRESETS_PATH = os.path.join(os.path.dirname(__file__),
                            "sampler_presets.json")

TEXT_BUCKETS = "768"
SPEAKER_BUCKETS = "640, 2816, 6400"
# Generation-length buckets for auto_sequence_length (latents; 640 ~ 29.7 s)
SEQUENCE_BUCKETS = "160, 320, 480, 640"

# Streaming block sizes (latents) and block-count cap.  40 exists for
# time-to-first-audio (1.86 s of audio); larger blocks amortize the
# per-block cost, so a GROWING schedule (40, 80, 160, 320, 320, ...) starts
# audio early and then keeps ahead of playback.
STREAM_CHUNK_SIZES = (40, 80, 160, 320)
MAX_STREAM_CHUNKS = 16
# Stream-TOTAL buckets (latents).  The JAX package pads a stream's prefix
# buffer to the smallest bucket >= its total to bound its compiled
# programs; the top bucket covers the largest acceptable schedule.
STREAM_TOTAL_BUCKETS = "320, 640, 960, 1280, 1920, 2560, 3840, 5120"


def pick_stream_total_bucket(total_latents: int,
                             buckets: str = STREAM_TOTAL_BUCKETS
                             ) -> Optional[int]:
    """Smallest bucket >= total, or None when total exceeds every bucket."""
    b = find_min_bucket_gte(buckets, total_latents)
    return None if b is None or b < total_latents else b


def growing_schedule(total_latents: int) -> list:
    """Block schedule for one stream: smallest first for first audio, then
    doubling up to 320.  total_latents must be reachable with
    STREAM_CHUNK_SIZES steps: the ramp, then 320s, then the largest
    fitting sizes."""
    out, acc = [], 0
    for c in STREAM_CHUNK_SIZES:
        if acc + c > total_latents:
            break
        out.append(c)
        acc += c
    while acc + 320 <= total_latents:
        out.append(320)
        acc += 320
    for c in reversed(STREAM_CHUNK_SIZES):
        while acc + c <= total_latents:
            out.append(c)
            acc += c
    if acc != total_latents:
        raise ValueError(
            f"total_latents {total_latents} not reachable with chunk sizes "
            f"{STREAM_CHUNK_SIZES} (got to {acc}); pick a multiple of 40")
    if len(out) > MAX_STREAM_CHUNKS:
        # the growing ramp means 16 blocks reach 40+80+160 + 13*320, not
        # 16*320: report the actual maximum so that a retry can succeed
        biggest = max(STREAM_CHUNK_SIZES)
        ramp = [c for c in STREAM_CHUNK_SIZES if c != biggest]
        max_total = sum(ramp) + (MAX_STREAM_CHUNKS - len(ramp)) * biggest
        raise ValueError(
            f"{total_latents} latents needs {len(out)} blocks, over the "
            f"serving cap MAX_STREAM_CHUNKS={MAX_STREAM_CHUNKS} "
            f"(max {max_total} latents per growing-schedule stream); "
            "split the text and resume with continuation_latent")
    return out


# Host-side speech-rate heuristic shared with the chunker
# (reference: handler.py:109 target_chars = duration * 12)
CHARS_PER_SECOND = 12.0
LATENTS_PER_SECOND = 44100.0 / 2048.0


def pick_sequence_bucket(text: str, max_sequence_length: int,
                         margin: float = 1.5,
                         buckets: str = SEQUENCE_BUCKETS) -> int:
    """Latency feature (off by default in the handler): bound the
    generation length by the text's estimated speech duration instead of
    always generating the full sequence and cropping.  margin=1.5 leaves
    headroom for slow delivery; the end-of-speech crop still trims the
    tail."""
    est_seconds = max(len(text), 1) / CHARS_PER_SECOND
    est_latents = int(est_seconds * LATENTS_PER_SECOND * margin)
    bucket = find_min_bucket_gte(buckets, est_latents)
    return min(bucket, max_sequence_length)


@functools.lru_cache(maxsize=1)
def load_presets(path: Optional[str] = None) -> Dict[str, Dict]:
    with open(path or PRESETS_PATH) as f:
        return json.load(f)


def get_preset(name: str) -> Dict:
    presets = load_presets()
    if name not in presets:
        raise KeyError(
            f"unknown sampler preset {name!r}; available: "
            f"{sorted(presets)}")
    return dict(presets[name])


def pick_text_bucket(actual_length: int,
                     buckets: str = TEXT_BUCKETS) -> int:
    return find_min_bucket_gte(buckets, actual_length)


def pick_speaker_bucket(actual_latents: int,
                        buckets: str = SPEAKER_BUCKETS) -> int:
    return find_min_bucket_gte(buckets, actual_latents)


def _parse_buckets(values_str: str) -> List[int]:
    return [int(v.strip()) for v in values_str.split(",") if v.strip()]


# The JAX package's streams carry the latent prefix from this total on and
# re-encode it below (its serve/streaming.py), and key their block
# programs on the choice; the port carries it at every length
# (serve/streaming.py), but the manifest keeps the JAX package's entries
# on both sides of the threshold, so that the two warm the same streams.
INCREMENTAL_LATENT_MIN_TOTAL = 2560


def _later_cover_schedule(tb: int, buckets: str = STREAM_TOTAL_BUCKETS,
                          min_total: int = 0) -> List[int]:
    """A valid stream schedule whose total lands in bucket `tb` and that
    holds every STREAM_CHUNK_SIZES entry reachable as a later (not first)
    block within the bucket, so that one stream warms every
    (total bucket, later block size) program the bucket can serve.  Sizes
    that would overflow the bucket as a later block (a later 320 in the
    320 bucket) never occur in traffic and are skipped.  min_total > 0
    tops the schedule up to at least that total, within the bucket (the
    threshold bucket's entry past INCREMENTAL_LATENT_MIN_TOTAL)."""
    totals = _parse_buckets(buckets)
    prev = max([t for t in totals if t < tb], default=0)
    sched = [min(STREAM_CHUNK_SIZES)]
    for c in sorted(STREAM_CHUNK_SIZES):
        if sum(sched) + c <= tb and len(sched) < MAX_STREAM_CHUNKS:
            sched.append(c)
    biggest = max(STREAM_CHUNK_SIZES)
    while (sum(sched) <= prev and sum(sched) + biggest <= tb
           and len(sched) < MAX_STREAM_CHUNKS):
        sched.append(biggest)
    for c in sorted(STREAM_CHUNK_SIZES, reverse=True):
        while (sum(sched) < min_total and sum(sched) + c <= tb
               and len(sched) < MAX_STREAM_CHUNKS):
            sched.append(c)
    if sum(sched) <= prev or sum(sched) < min_total:
        raise ValueError(
            f"cannot build a schedule landing in total bucket {tb} "
            f"(>= {min_total}) within MAX_STREAM_CHUNKS="
            f"{MAX_STREAM_CHUNKS}")
    return sched


def warmup_manifest(batch_sizes=(), *, full: bool = False,
                    default_sequence_length: Optional[int] = None
                    ) -> List[Dict]:
    """Every static shape the serving surface accepts, derived from the
    constants request validation uses (this module), so that the warmed
    and the accepted surfaces cannot drift apart.  Entry kinds, run by
    serve.handler.warmup_compile through the real request paths, so that
    the programs' keys are production's:

      {"kind": "oneshot", "text_bucket", "speaker_bucket", "sequence_length"}
      {"kind": "stream",  "speaker_bucket", "chunk_sizes", "total_bucket"}
      {"kind": "batch",   "batch_size", "speaker_bucket", "sequence_length"}

    full=False warms the high-traffic subset: the default sequence
    length, speaker {none, smallest bucket}, the default stream schedule
    and the growing one, and the given batch sizes.  full=True lists the
    whole accepted surface: every sequence bucket x speaker bucket, and
    every (stream-total bucket x block size x first/later) stream."""
    from ..config import MAX_TEXT_LENGTH, SAMPLER_DEFAULTS
    seq_default = (default_sequence_length
                   or SAMPLER_DEFAULTS["sequence_length"])
    # every request path pads text to MAX_TEXT_LENGTH, so there is one
    # text width; a second TEXT_BUCKETS value would need a request path
    # that buckets text, and its own entries here
    text_buckets = _parse_buckets(TEXT_BUCKETS)
    if text_buckets != [MAX_TEXT_LENGTH]:
        raise AssertionError(
            f"TEXT_BUCKETS {text_buckets} != [MAX_TEXT_LENGTH "
            f"{MAX_TEXT_LENGTH}]: request paths pad text to "
            "MAX_TEXT_LENGTH only; a text bucket needs bucketed request "
            "paths and warmup_manifest entries")
    speaker_all = [None] + _parse_buckets(SPEAKER_BUCKETS)
    seq_all = sorted(set(_parse_buckets(SEQUENCE_BUCKETS)) | {seq_default})
    totals = _parse_buckets(STREAM_TOTAL_BUCKETS)
    sizes = list(STREAM_CHUNK_SIZES)

    speakers = speaker_all if full else [None, speaker_all[1]]
    seqs = seq_all if full else [seq_default]

    entries = [{"kind": "oneshot", "text_bucket": t, "speaker_bucket": s,
                "sequence_length": q}
               for t in text_buckets for s in speakers for q in seqs]

    def stream_entry(s, schedule):
        return {"kind": "stream", "speaker_bucket": s,
                "chunk_sizes": list(schedule),
                "total_bucket": pick_stream_total_bucket(sum(schedule))}

    if full:
        # later blocks are keyed on (total bucket, block size), first ones
        # on the block size alone: per (total bucket x speaker) one stream
        # holding every reachable size as a later block, and one
        # single-block stream per other size for the first blocks; the
        # threshold bucket also gets a stream past
        # INCREMENTAL_LATENT_MIN_TOTAL
        for s in speakers:
            for c in sizes[1:]:
                entries.append(stream_entry(s, [c]))
            for tb in totals:
                entries.append(stream_entry(s, _later_cover_schedule(tb)))
                if (tb >= INCREMENTAL_LATENT_MIN_TOTAL
                        and sum(_later_cover_schedule(tb))
                        < INCREMENTAL_LATENT_MIN_TOTAL):
                    entries.append(stream_entry(s, _later_cover_schedule(
                        tb, min_total=INCREMENTAL_LATENT_MIN_TOTAL)))
    else:
        for s in speakers:
            entries.append(stream_entry(s, [160] * 4))   # default schedule
            entries.append(stream_entry(s, list(sizes)))  # growing ramp
    # a batch program is keyed on its batch size and sequence length too
    # (the server groups requests by identical sampler parameters), so the
    # batch entries cover the one-shot entries' sequence lengths
    for b in batch_sizes:
        for s in speakers:
            for q in seqs:
                entries.append({"kind": "batch", "batch_size": int(b),
                                "speaker_bucket": s, "sequence_length": q})
    return entries


def batch_size_buckets(max_batch: int) -> Tuple[int, ...]:
    """The batch sizes the micro-batch server pads its groups to: powers of
    two below max_batch, and max_batch.  Every batch size is its own
    (G*B)-row sampler program, and a drain can gather any count from 1 to
    max_batch: padding to this set keeps O(log max_batch) programs, not
    one per count (serve/server.py)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = {max_batch}
    b = 1
    while b < max_batch:
        out.add(b)
        b *= 2
    return tuple(sorted(out))


def pick_batch_bucket(n: int, max_batch: int) -> int:
    """The smallest batch bucket >= n (n in 1..max_batch)."""
    for b in batch_size_buckets(max_batch):
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds max_batch {max_batch}")
