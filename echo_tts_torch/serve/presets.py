"""Streaming block schedules.

Counterpart of the streaming part of echo_tts_tpu/serve/presets.py
(:29-90), copied as it is: the block sizes a stream may use, the cap on
its block count, the stream-total buckets and the growing schedule.  The
sampler presets, the text/speaker/sequence buckets, the warm-up manifest
and the batch buckets wait for the serving slice.
"""
from __future__ import annotations

from typing import Optional

from ..pipeline.text import find_min_bucket_gte

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
