"""Long-stream soak gate: one stream at the largest serving schedule, end to
end.  Counterpart of examples/soak_long_stream.py.

Runs ONE stream of 16 blocks of 320 latents = 5120 latents (about 3 min
58 s of audio; MAX_STREAM_CHUNKS x the largest block, the top stream-total
bucket, serve/presets.py) through serve/streaming.stream_synthesize: the
blockwise sampler with its latent prefix carried block to block, the
incremental codec decode with kernel B's history form, at the published
widths with seeded random weights (pipeline.random_models) and a speaker
of 640 random latents (160 patch columns).  It gates on:

  * flat per-block latency: the median of the last 4 blocks <= 1.5x the
    median of blocks 2-5 (block 1 has no latent prefix, a cheaper shape).
    A prefix whose cost grew with the stream would fail here;
  * no device-memory growth: torch.cuda.memory_allocated() after the
    measured stream within 256 MB of its reading after the warm pass (a
    buffer kept per block would fail here).  memory_reserved() is not read:
    the caching allocator keeps freed blocks reserved.  On the CPU there is
    no reading and the gate is skipped;
  * the audio finite and exactly total x frame_length samples.

Before the measured stream a warm pass streams the first 2 blocks only:
the JAX script's warm pass compiles every XLA program the schedule
reaches, while eager PyTorch compiles nothing per shape and the kernels are
built on first use, so two blocks (the latent-free first block and one
with a prefix) reach every code path.

The report is one JSON line (also written to --report): the per-block
table (block ms and elapsed seconds on the host clock, each block's wait
ending in the copy of its audio to the host; device memory), the gates'
numbers, and the kernels' launches in the measured stream.  Exits 1 when a
gate fails.

    python -m echo_tts_torch.examples.soak_long_stream        # on the card
    python -m echo_tts_torch.examples.soak_long_stream --tiny --blocks 8 \
        --device cpu

--tiny runs the tiny config in fp32 with blocks of 8 latents and 2 steps.
Like every entry point it runs on the card unless --device cpu or
ECHO_DEVICE=cpu is given; the tiny config's heads are not kernel A's, so
--tiny needs the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SAMPLER_DEFAULTS, tiny_dac_config, tiny_dit_config
from ..device import card_name, resolve_device
from ..ops.joint_attention import fused_joint_attention
from ..ops.res_stack import fused_res_stack
from ..pipeline.pipeline import random_models
from ..serve.streaming import stream_synthesize

BLOCK = 320
WARM_BLOCKS = 2
TINY_STEPS = 2
TAIL_OVER_MID_BOUND = 1.5
MEMORY_GROWTH_BOUND = 256 * 2**20
TEXT = ("A very long narration that keeps going for minutes on end, "
        "sentence after sentence, so the stream reaches its maximum "
        "accepted schedule without repeating itself too obviously. ") * 6


def memory_allocated(device: torch.device) -> Optional[int]:
    """The bytes the caching allocator has handed out on the card; None on
    the CPU."""
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else None


def launches() -> dict:
    """Kernel A's launches, and kernel B's wrapper calls one-shot and in
    the history form, as their wrappers count them."""
    return {"joint_attention": fused_joint_attention.launches,
            "res_stack": fused_res_stack.launches,
            "res_stack_stream": fused_res_stack.launches_stream}


def run_stream(models, schedule: List[int], speaker_latent: np.ndarray,
               sampler_params: dict, table: Optional[list] = None
               ) -> Tuple[np.ndarray, float]:
    """One stream on `schedule`; returns (its audio (1, samples), wall
    seconds).  With `table`, appends one row a block."""
    dev = models.device
    pieces = []
    t0 = last = time.perf_counter()
    for chunk in stream_synthesize(
            models, TEXT, speaker_latent=speaker_latent,
            chunk_sizes=schedule, seed=0, sampler_params=sampler_params):
        now = time.perf_counter()
        if table is not None:
            mem = memory_allocated(dev)
            table.append({"block": chunk.index,
                          "latents": chunk.latent_end - chunk.latent_start,
                          "block_ms": 1e3 * (now - last),
                          "elapsed_s": now - t0,
                          "memory_mb": None if mem is None else mem / 2**20})
        pieces.append(chunk.audio)
        last = time.perf_counter()
    return np.concatenate(pieces, axis=-1), time.perf_counter() - t0


def gates(table: list, audio: np.ndarray, expect_samples: int,
          mem_baseline: Optional[int], mem_after: Optional[int]
          ) -> Tuple[dict, List[str]]:
    """The gates' numbers and the failures (an empty list when all hold).
    The latency gate needs at least 8 blocks, the memory gate two
    readings."""
    numbers, failures = {}, []
    if len(table) >= 8:
        mid = float(np.median([b["block_ms"] for b in table[1:5]]))
        tail = float(np.median([b["block_ms"] for b in table[-4:]]))
        numbers["tail_over_mid_ratio"] = tail / mid
        if tail / mid > TAIL_OVER_MID_BOUND:
            failures.append(f"per-block latency grows: tail/mid = "
                            f"{tail / mid:.3f} > {TAIL_OVER_MID_BOUND}")
    if mem_baseline is not None and mem_after is not None:
        growth = mem_after - mem_baseline
        numbers["memory_growth_mb"] = growth / 2**20
        if growth > MEMORY_GROWTH_BOUND:
            failures.append(f"device memory grew {growth / 2**20:.1f} MB "
                            f"across the stream (bound "
                            f"{MEMORY_GROWTH_BOUND / 2**20:.0f} MB)")
    if not np.isfinite(audio).all():
        failures.append("non-finite samples in the audio")
    if audio.shape[-1] != expect_samples:
        failures.append(f"audio length {audio.shape[-1]} != {expect_samples}")
    return numbers, failures


def main(argv=None, *, models=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=16,
                    help="blocks of 320 latents (16: the largest serving "
                    "schedule, 5120 latents)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny config in fp32, blocks of 8, 2 steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: ECHO_DEVICE, else cuda)")
    ap.add_argument("--report", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    if models is None:
        device = resolve_device(args.device or os.environ.get("ECHO_DEVICE")
                                or "cuda")
        if args.tiny and device.type == "cuda":
            ap.error("the tiny config's heads (16 wide, fp32) are not kernel "
                     "A's; run --tiny with --device cpu")
        if args.tiny:
            models = random_models(device, torch.float32,
                                   dit_cfg=tiny_dit_config(),
                                   dac_cfg=tiny_dac_config())
        else:
            # published widths, blockwise; on the card bf16 with the serving
            # codec (the decoder's polynomial snake)
            models = random_models(device)
    block = 8 if args.tiny else BLOCK
    p = dict(SAMPLER_DEFAULTS)
    p.pop("sequence_length")
    if args.tiny:
        p["num_steps"] = TINY_STEPS
    schedule = [block] * args.blocks
    total = sum(schedule)
    cfg = models.dit_cfg
    spk_len = 2 * cfg.speaker_patch_size if args.tiny else 640
    spk = (0.1 * np.random.default_rng(3).standard_normal(
        (1, spk_len, cfg.latent_size))).astype(np.float32)
    dev = models.device

    _, warm_s = run_stream(models, schedule[:WARM_BLOCKS], spk, p)
    mem_baseline = memory_allocated(dev)
    before = launches()
    table: list = []
    audio, wall_s = run_stream(models, schedule, spk, p, table)
    mem_after = memory_allocated(dev)
    after = launches()

    dac = models.dac_cfg
    audio_s = total * dac.frame_length / dac.sample_rate
    numbers, failures = gates(table, audio, total * dac.frame_length,
                              mem_baseline, mem_after)
    report = {
        "card": card_name(dev),
        "schedule": f"{args.blocks} x {block}",
        "total_latents": total,
        "num_steps": p["num_steps"],
        "audio_seconds": audio_s,
        "audio_samples": int(audio.shape[-1]),
        "wall_seconds": wall_s,
        "streamed_rtf": audio_s / wall_s,
        "warm_blocks": len(schedule[:WARM_BLOCKS]),
        "warm_pass_seconds": warm_s,
        "memory_baseline_mb": (None if mem_baseline is None
                               else mem_baseline / 2**20),
        "memory_after_mb": None if mem_after is None else mem_after / 2**20,
        "launches": {k: after[k] - before[k] for k in after},
        "blocks": table,
        **numbers,
        "failures": failures,
        "ok": not failures,
    }
    line = json.dumps(report)
    print(line, flush=True)
    if args.report:
        with open(args.report, "w") as f:
            f.write(line + "\n")
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
