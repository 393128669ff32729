"""Sampler presets, the shape buckets that set outputs, and the streaming
block schedules.

Counterpart of echo_tts_tpu/serve/presets.py.  Presets mirror the
reference's sampler_presets.json (6 presets varying CFG scales,
truncation and temporal rescale; reference: sampler_presets.json:1-62,
loaded at gradio_app.py:431-451); a copy of the JSON ships with this
package.  The buckets kept are those that change what a request returns
or that batching needs: the sequence bucket of `auto_sequence_length` (the
audio's length), the speaker bucket (the padded speaker width that the
voice cache stores and a batch stacks at, batcher.py:149-154) and the
text bucket.  The streaming part (block sizes, block-count cap,
stream-total buckets, growing schedule) is copied as it is.

Left out, because they only bound the number of compiled XLA programs and
an eager PyTorch program compiles nothing per shape: `batch_size_buckets`
/ `pick_batch_bucket` (the server runs each group at its own size),
`warmup_manifest` and `_later_cover_schedule` (the port's warm-up builds
the kernels instead, serve/handler.warmup_compile).  The blockwise
sampler leaves out the JAX package's `total_len_bucket` for the same
reason.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional

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
