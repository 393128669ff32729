"""Where the one-shot path's device time goes, on one CUDA card.

    python -m echo_tts_torch.tools.profile_main_path

Builds the seeded random models at full width (pipeline.random_models),
answers one voice-cloned request (tests/data/voice.wav as the speaker,
SAMPLER_DEFAULTS) to warm up, then runs its three stages again: the
speaker encode (get_speaker_latent_and_mask), the sampler (prefill + 40
Euler steps) and the decode (ae_decode).  The three
stages first run REPS times without the profiler, for their wall times
(the median is used, all are printed), and then each once more under it,
for the device-busy time (the union of every kernel, copy and set interval
the profiler saw).  The wall times come first because the profiler's host
work, and the tracing it leaves attached after its first use, would
inflate them.  It prints both, the idle share 1 - busy / median wall, and
the TOP kernels that took the most device time; the two hand-written kernels
are named so their share can be read off.  The last line is one JSON
object with those numbers.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config import SAMPLER_DEFAULTS, MAX_TEXT_LENGTH
from ..pipeline import audio_io, pipeline as pl
from ..pipeline.text import get_text_input_ids_and_mask

VOICE = Path(__file__).resolve().parents[2] / "tests" / "data" / "voice.wav"
TEXT = ("The quick brown fox jumps over the lazy dog, then reads it a "
        "bedtime story.")
REPS = 5    # unprofiled runs of each stage (host-bound stages vary run to run)
TOP = 12    # kernels listed per stage
KERNELS = {"joint_attention_kernel": "joint_attention (csrc)",
           "res_stack_kernel": "res_stack (csrc)"}


def _label(name: str) -> str:
    for key, label in KERNELS.items():
        if key in name:
            return label
    return name[:90]


def _device_summary(prof) -> dict:
    """Busy time (union of device intervals) and the top kernels by time."""
    spans, by_name = [], defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        entry = by_name[_label(ev.name)]
        entry[0] += 1
        entry[1] += (end - start) / 1e3
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"busy_ms": busy / 1e3, "kernel_ms_sum": sum(v[1] for v in by_name.values()),
            "top": [{"name": n, "calls": c, "ms": ms} for n, (c, ms) in ranked[:TOP]]}


def _timed(fn, reps: int):
    """(fn(), [wall ms of each of `reps` runs]), the card synchronised on
    both sides of each run."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, walls


def _profiled(name: str, fn, walls: list) -> dict:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = statistics.median(walls)
    res = {"stage": name, "wall_ms": wall, "wall_ms_runs": walls,
           **_device_summary(prof)}
    res["idle_share"] = 1.0 - res["busy_ms"] / wall
    print(f"{name}: wall {wall:.1f} ms (runs {[round(w, 1) for w in walls]}), "
          f"device busy {res['busy_ms']:.1f} ms, idle share "
          f"{res['idle_share']:.3f}", flush=True)
    for k in res["top"]:
        print(f"    {k['ms']:10.2f} ms {k['calls']:6d}x  {k['name']}", flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    models = pl.random_models()
    sample_fn = functools.partial(pl.euler_sample_fn, **SAMPLER_DEFAULTS)
    voice = audio_io.load_audio(str(VOICE))
    pl.sample_pipeline(models, sample_fn, TEXT, voice, 0)   # warm-up

    def encode():
        return pl.get_speaker_latent_and_mask(models, voice)

    (lat, mask), enc_ms = _timed(encode, REPS)
    ids, tmask = get_text_input_ids_and_mask([TEXT], MAX_TEXT_LENGTH)
    inputs = [torch.from_numpy(a).to(models.device)
              for a in (lat, mask, ids, tmask)]

    def sample():
        return sample_fn(models, *inputs, 0)

    latents, smp_ms = _timed(sample, REPS)

    def decode():
        return pl.ae_decode(models, latents)

    _, dec_ms = _timed(decode, REPS)
    stages = [_profiled("encode", encode, enc_ms),
              _profiled("sampler", sample, smp_ms),
              _profiled("decode", decode, dec_ms)]
    print(json.dumps({"card": card, "stages": stages}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
