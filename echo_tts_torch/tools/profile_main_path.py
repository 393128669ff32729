"""Where the main path's device time goes, on one CUDA card.

    python -m echo_tts_torch.tools.profile_main_path [--stream | --batch | --train]

Builds the seeded random models at full width (pipeline.random_models),
answers one voice-cloned request (tests/data/voice.wav as the speaker,
SAMPLER_DEFAULTS) to warm up, then runs its three stages again: the
speaker encode (get_speaker_latent_and_mask), the sampler (prefill + 40
Euler steps) and the decode (ae_decode); and a fourth, the sampler in the
int8 serving modes (the same DiT through ops.quant.quantize_dit, as
serve.models.load_models builds it under ECHO_DIT_QUANT=int8, and
kv_quant=True) on the same inputs.  The four
stages first run REPS times without the profiler, for their wall times
(the median is used, all are printed), and then each once more under it,
for the device-busy time (the union of every kernel, copy and set interval
the profiler saw).  The wall times come first because the profiler's host
work, and the tracing it leaves attached after its first use, would
inflate them.  It prints both, the idle share 1 - busy / median wall, and
the TOP kernels that took the most device time; the hand-written kernels
(and kernel C's pre-pass) are named, and listed apart with their launches
whether or not they are among the TOP, so their share can be read off.  The last line is one JSON
object with those numbers.

With --stream it profiles instead the first chunk of chip_smoke.py's
streaming request (e): stream_synthesize on growing_schedule(640) with
that voice, pre-encoded so that the stage is the prefill, the 40-latent
first block's sampler and its first decode_zq_block, up to the chunk's
audio on the host.  The same REPS unprofiled runs, then one profiled.

With --batch it profiles instead chip_smoke.py's micro-batched request
(h): serve.batcher.run_batch over eight requests (four with the voice's
latent, padded to its speaker bucket, four without) with SAMPLER_DEFAULTS,
as one stage (the B = 8 sampler pass, the decode in slices of 4, the
crops) and its sampler pass alone.

With --train it profiles instead one step of chip_smoke.py's request (i):
train.step's train step under remat "attn" at B = 2 on a batch of the
DataConfig shapes (640 latents, 768 text bytes, 640 speaker latents), on
the published DiT at blockwise=False with seeded random bf16 weights, t
and eps fixed.  Beside the top kernels it gives the device time under
kernel A's forward op (echo_tts::joint_attention) and under its autograd
backward (the plain recompute, _KernelWithPlainGradBackward), and under
the optimizer update.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config import SAMPLER_DEFAULTS, MAX_TEXT_LENGTH
from ..device import card_name
from ..ops.quant import quantize_dit
from ..pipeline import audio_io, pipeline as pl
from ..pipeline.text import get_text_input_ids_and_mask
from ..sampler.euler import sample_euler_cfg_independent_guidances
from ..serve import batcher
from ..serve.presets import growing_schedule, pick_speaker_bucket
from ..serve.streaming import stream_synthesize

VOICE = Path(__file__).resolve().parents[2] / "tests" / "data" / "voice.wav"
TEXT = ("The quick brown fox jumps over the lazy dog, then reads it a "
        "bedtime story.")
REPS = 5    # unprofiled runs of each stage (host-bound stages vary run to run)
TOP = 12    # kernels listed per stage
KERNELS = {"joint_attention_kernel": "joint_attention (csrc)",
           "res_unit_kernel": "res_stack (csrc)",
           "int8_matmul_kernel": "int8_matmul (csrc)",
           "int8_quantize_rows_kernel": "int8_matmul pre-pass (csrc)"}


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
            "top": [{"name": n, "calls": c, "ms": ms} for n, (c, ms) in ranked[:TOP]],
            "hand_written": {n: {"calls": c, "ms": ms} for n, (c, ms) in by_name.items()
                             if n in KERNELS.values()}}


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


def _profiled(name: str, fn, walls: list, scopes=()) -> dict:
    """One profiled run of fn: wall (median of `walls`), device busy, idle
    share, the top kernels, the hand-written ones, and the device time
    under each (label, host op name) of `scopes` (_scope_ms)."""
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
    for n, k in res["hand_written"].items():
        print(f"    hand-written: {n} {k['ms']:.3f} ms, {k['calls']} launches",
              flush=True)
    res["scopes"] = {}
    for label, key in scopes:
        ms = _scope_ms(prof, key)
        res["scopes"][label] = {"ms": ms, "share_of_busy": ms / res["busy_ms"]}
        print(f"    under {label}: {ms:.2f} ms ({100 * ms / res['busy_ms']:.1f}"
              " % of the busy time)", flush=True)
    return res


def stream_stages(models, voice) -> list:
    """Request (e)'s first chunk: prefill, first block, first decode."""
    lat, mask = pl.get_speaker_latent_and_mask(models, voice)

    def first_chunk():
        stream = stream_synthesize(models, TEXT, chunk_sizes=growing_schedule(640),
                                   seed=5, speaker_latent=lat, speaker_mask=mask)
        chunk = next(stream)
        stream.close()
        return chunk

    first_chunk()                                           # warm-up
    _, walls = _timed(first_chunk, REPS)
    return [_profiled("stream_first_chunk", first_chunk, walls)]


def batch_stages(models, voice) -> list:
    """Request (h)'s pass at B = 8, whole and its sampler alone."""
    n = voice.shape[-1] // models.dac_cfg.frame_length
    lat, mask = pl.get_speaker_latent_and_mask(
        models, voice, max_speaker_latent_length=pick_speaker_bucket(n),
        pad_to_max=True)
    reqs = [batcher.BatchRequest(f"{TEXT} Request {i}.", seed=i,
                                 speaker_latent=lat if i < 4 else None,
                                 speaker_mask=mask if i < 4 else None)
            for i in range(8)]

    def batch():
        return batcher.run_batch(models, reqs, SAMPLER_DEFAULTS)

    params = dict(SAMPLER_DEFAULTS)
    seq = params.pop("sequence_length")
    ids, tmask = get_text_input_ids_and_mask([r.text for r in reqs],
                                             MAX_TEXT_LENGTH)
    spk = torch.zeros((8, lat.shape[1], lat.shape[2]))
    smask = torch.zeros((8, lat.shape[1]), dtype=torch.bool)
    spk[:4], smask[:4] = torch.from_numpy(lat), torch.from_numpy(mask)
    inputs = [x.to(models.device) for x in (spk, smask, torch.from_numpy(ids),
                                            torch.from_numpy(tmask))]
    noise = batcher.draw_noise(range(8), seq, models.dit_cfg.latent_size,
                               models.device)

    def sampler():
        return sample_euler_cfg_independent_guidances(
            models.dit, *inputs, sequence_length=seq, dtype=models.dtype,
            initial_noise=noise, **params)

    batch()                                                 # warm-up
    _, batch_ms = _timed(batch, REPS)
    _, smp_ms = _timed(sampler, REPS)
    return [_profiled("batch_b8", batch, batch_ms),
            _profiled("sampler_b8", sampler, smp_ms)]


def _scope_ms(prof, key: str) -> float:
    """The device ms of the host ops whose name holds `key`, each with the
    kernels of the ops under it, not counting one nested in another."""
    total = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or key not in ev.name:
            continue
        parent = ev.cpu_parent
        while parent is not None and key not in parent.name:
            parent = parent.cpu_parent
        if parent is None:
            total += ev.device_time_total / 1e3
    return total


def train_stages() -> list:
    """Request (i)'s train step under remat "attn", profiled."""
    from ..config import base_dit_config
    from ..models.dit import init_dit
    from ..train import step as tstep

    model = init_dit(base_dit_config(blockwise=False), seed=0)
    dev, lat = model.in_proj.weight.device, model.cfg.latent_size
    g = torch.Generator(device=dev).manual_seed(60)
    ids, tmask = get_text_input_ids_and_mask([TEXT, TEXT[:40]],
                                             MAX_TEXT_LENGTH)
    smask = torch.zeros((2, 640), dtype=torch.bool, device=dev)
    smask[0], smask[1, :300] = True, True
    batch = {"latents": torch.randn((2, 640, lat), generator=g, device=dev),
             "text_ids": torch.from_numpy(ids).to(dev),
             "text_mask": torch.from_numpy(tmask).to(dev),
             "speaker_latent": torch.randn((2, 640, lat), generator=g,
                                           device=dev),
             "speaker_mask": smask}
    t = torch.rand((2,), generator=g, device=dev)
    eps = torch.randn((2, 640, lat), generator=g, device=dev)
    tx = tstep.make_optimizer()
    state = tstep.create_train_state(model, tx)
    del model
    step = tstep.make_train_step(tx, remat="attn")

    def train_step():
        return step(state, batch, t=t, eps=eps)

    train_step()                                            # warm-up
    _, walls = _timed(train_step, REPS)
    return [_profiled("train_step_attn_b2", train_step, walls, scopes=(
        ("kernel A forward", "echo_tts::joint_attention"),
        ("kernel A plain-recompute backward", "_KernelWithPlainGradBackward"),
        ("optimizer update", "Optimizer.step")))]


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    print(card, flush=True)
    if "--train" in argv:
        print(json.dumps({"card": card, "stages": train_stages()}), flush=True)
        return 0

    models = pl.random_models()
    sample_fn = functools.partial(pl.euler_sample_fn, **SAMPLER_DEFAULTS)
    voice = audio_io.load_audio(str(VOICE))
    if "--stream" in argv:
        print(json.dumps({"card": card, "stages": stream_stages(models, voice)}),
              flush=True)
        return 0
    if "--batch" in argv:
        print(json.dumps({"card": card, "stages": batch_stages(models, voice)}),
              flush=True)
        return 0
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

    qmodels = dataclasses.replace(models, dit=quantize_dit(models.dit))
    sample_fn_q = functools.partial(pl.euler_sample_fn, kv_quant=True,
                                    **SAMPLER_DEFAULTS)

    def sample_int8():
        return sample_fn_q(qmodels, *inputs, 0)

    sample_int8()                                           # warm-up
    _, smp8_ms = _timed(sample_int8, REPS)
    stages = [_profiled("encode", encode, enc_ms),
              _profiled("sampler", sample, smp_ms),
              _profiled("decode", decode, dec_ms),
              _profiled("sampler_int8", sample_int8, smp8_ms)]
    print(json.dumps({"card": card, "stages": stages}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
