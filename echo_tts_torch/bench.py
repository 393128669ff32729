"""Headline benchmark: voice-cloned TTS real-time factor on one card.
Counterpart of bench.py.

Times the whole generation path for one 640-latent utterance (29.7 s of
audio at 44.1 kHz, 2048 samples a latent) over a 640-latent speaker
reference, the reference's headline configuration (40 Euler steps, CFG
text 3.0 / speaker 8.0 on t in [0.5, 1]), and the same path's streamed,
served and batched forms.  Seeded random weights: timing does not depend
on their values.  One JSON line with bench.py's keys:

  value / vs_baseline  audio seconds / wall seconds of one request (the
               prefill, the sampler, PCA unwhiten and the codec's decode;
               the audio stays on the card), median of 3; over
               BASELINE_RTF, the reference's RTX 4090 figure
  prefill_ms   the text and speaker K/V (sampler/euler.prefill_static)
  sampler_ms   the 40-step loop over them (sampler/euler.run_step_segments)
  decode_ms    PCA unwhiten + decode (pipeline.ae_decode), 640 latents
  p50_short_ms one request at seq 224 (10.4 s of audio), median of 5
  sampler_int8_ms, rtf_int8  the loop over the W8A8 DiT
               (ops/quant.quantize_dit, ECHO_DIT_QUANT=int8's DiT; opt-in,
               non-parity) on the same prefill and noise; the RTF from
               prefill + sampler_int8 + decode
  ttfa_ms, streamed_rtf  serve/streaming.stream_synthesize of 1240
               latents on blocks (40, 80, 160, 320, 320, 320): seconds to
               the first block's audio on the host; audio seconds over
               seconds to the last; median of 3
  ttfa_serve_ms  the same stream through serve/handler.
               iter_synthesize_stream (validation, the cached voice
               latent of a 640-latent WAV, each block's WAV written) to
               its first block event, median of 3
  throughput_rtf_b8  eight requests through one serve/batcher.run_batch
               at seq 640 (one (3 x 8)-row sampler, decodes of four):
               audio seconds of the eight over wall seconds, median of 2
  throughput_rtf_b8_chip  the same batch's device stages alone: prefill
               at B = 8, the sampler at GB = 24 / 8, two decodes of four,
               one synchronise at the end, median of 2

plus `card` (the card's name and power limit) and `ranges` (each timed
key's smallest and largest run).  Each stage runs one untimed call
first; --warmup and --reps replace every stage's counts when given.  A
stage is clocked on the host between two synchronises of the card
(utils.profiling.wall_ms).  bench.py's scalar-checksum barriers have no
counterpart: a synchronise ends the card's work.  As bench.py's stages
are jitted programs, the sampler, the codec and the stages here are
captured programs (utils/programs.py, a CUDA graph per key and shape):
a stage's untimed call runs eagerly and captures, the timed calls
replay; the streams too (the fused first block, the block programs of
the stream's total bucket, the prefix's appends and the block decodes:
serve/streaming.py).  Each stage's output is checked (finite; the batch's eight
results; the stream's six blocks of 1240 x 2048 samples); a stage that
fails exits 1 with its name and no line.

The one-shot stages run a DiT without the latent encoder (blockwise=False,
seed 0), as bench.py does; the streamed, served and batched ones run the
blockwise `models` (seeded random ones unless given), which share its
codec and PCA.  The one-shot DiT is freed before them.

    python3 -m echo_tts_torch.bench
    python3 -m echo_tts_torch.bench --tiny --device cpu
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from .models.dit import init_dit
from .ops.quant import dit_is_quantized, quantize_dit
from .pipeline import audio_io
from .pipeline.pipeline import EchoModels, ae_decode
from .sampler.euler import sample_euler_cfg_independent_guidances
from .serve import handler
from .serve.batcher import BatchRequest, run_batch
from .serve.config import load_config
from .examples import stages

SHORT_SEQ, TINY_SHORT_SEQ = 224, 8
BASELINE_RTF = 3.0          # RTX 4090 (reference docs/diagrams/dataflow.svg)
NOISE_SEED = 2              # the one-shot request's noise, every call
B8_NOISE_SEED = 7           # the B = 8 device stages' noise
VOICE_SEED = 3              # the served voice's samples
# the handler takes only the serving block sizes
# (serve/presets.STREAM_CHUNK_SIZES): --tiny serves one block of 40
TINY_SERVE_BLOCKS = (40,)
BATCH = 8
# bench.py's sample counts, each after one untimed call
REPS = dict(value=3, prefill=3, sampler=3, decode=3, p50_short=5,
            sampler_int8=3, stream=3, serve=3, batch=2, b8_chip=2)


class StageFailed(Exception):
    pass


def stage(name: str, fn, *args):
    """fn(*args), a named stage: any error in it becomes StageFailed with
    the stage's name."""
    try:
        return fn(*args)
    except Exception as exc:                # noqa: BLE001 - named and re-raised
        raise StageFailed(f"{name}: {type(exc).__name__}: {exc}") from exc


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def sampler_kw(steps: int) -> dict:
    """bench.py's sampler_kw."""
    return dict(num_steps=steps, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
                cfg_min_t=0.5, cfg_max_t=1.0)


def generate(models: EchoModels, inputs: dict, seq: int, steps: int,
             noise=None):
    """bench.py's generate: the sampler (prefill, then the steps) from
    `noise`, else from a generator seeded NOISE_SEED on the card, then
    PCA unwhiten and decode; (latents, audio), both on the card."""
    draw = (dict(initial_noise=noise) if noise is not None else dict(
        generator=torch.Generator(device=models.device).manual_seed(
            NOISE_SEED)))
    latents = sample_euler_cfg_independent_guidances(
        models.dit, inputs["speaker_latent"], inputs["speaker_mask"],
        inputs["text_ids"], inputs["text_mask"], sequence_length=seq,
        dtype=models.dtype, **sampler_kw(steps), **draw)
    return latents, ae_decode(models, latents)


def batch_inputs(inputs: dict, seq: int) -> dict:
    """The request's inputs tiled to BATCH rows, with BATCH rows of noise
    drawn on the host from B8_NOISE_SEED."""
    out = {k: v.repeat(BATCH, *([1] * (v.ndim - 1)))
           for k, v in inputs.items() if k != "noise"}
    latent = inputs["speaker_latent"].shape[-1]
    out["noise"] = torch.randn(
        (BATCH, seq, latent),
        generator=torch.Generator().manual_seed(B8_NOISE_SEED)).to(
            inputs["noise"].device)
    return out


def b8_stages(models: EchoModels, inputs8: dict, plan):
    """bench.py's _b8_chip work: the prefill at B = 8, the sampler at GB =
    24 / 8, the decode of rows 0-3 and of 4-7, with no synchronise between
    them; (latents, [audio of rows 0-3, of 4-7])."""
    pre = stages.prefill(models.dit, inputs8, models.dtype)
    latents = stages.sampler(models.dit, plan, pre, inputs8, models.dtype)
    half = BATCH // 2
    return latents, [ae_decode(models, latents[:half]),
                     ae_decode(models, latents[half:])]


def serve_once(models: EchoModels, job: dict, cfg):
    """One streamed job through the handler; (seconds to its first block
    event, every event).  The stream is drained, so that no work of it is
    left when the next starts."""
    t0 = time.perf_counter()
    ttfa, events = None, []
    for ev in handler.iter_synthesize_stream(job, cfg=cfg, models=models):
        if ttfa is None and ev.get("event") == "block":
            ttfa = time.perf_counter() - t0
        events.append(ev)
    return ttfa, events


def run(args, models: EchoModels, lengths: stages.Lengths) -> dict:
    """Every stage in bench.py's order; the JSON line's fields."""
    dev, dt = models.device, models.dtype
    steps, seq = lengths.steps, lengths.seq
    short = TINY_SHORT_SEQ if args.tiny else SHORT_SEQ
    stream_blocks = stages.TINY_STREAM_BLOCKS if args.tiny else stages.STREAM_BLOCKS
    serve_blocks = TINY_SERVE_BLOCKS if args.tiny else stages.STREAM_BLOCKS
    kw = sampler_kw(steps)
    plan = stages.step_plan(steps)
    audio_s = stages.audio_seconds(models, seq)
    spl = models.dac_cfg.frame_length
    inputs = stages.request_inputs(models.dit_cfg, 1, lengths,
                                   lengths.speaker, dev)

    def timed(fn, key):
        return stages.timed_stage(fn, args, args.reps or REPS[key])

    runs = {}

    # the one-shot stages, on a DiT without the latent encoder
    one_shot = dataclasses.replace(models, dit=init_dit(
        dataclasses.replace(models.dit_cfg, blockwise=False), device=dev,
        dtype=dt, seed=0))

    def one_shot_stage():
        (latents, audio), runs["value"] = timed(
            lambda: generate(one_shot, inputs, seq, steps), "value")
        check(finite(latents, audio) and audio.shape == (1, seq * spl),
              f"audio {tuple(audio.shape)} finite {finite(audio)}")

    def prefill_stage():
        pre, runs["prefill_ms"] = timed(
            lambda: stages.prefill(one_shot.dit, inputs, dt), "prefill")
        check(finite(*pre.kv_static), "static K/V not finite")
        check(pre.kv_static[0].shape[2] == lengths.text
              + lengths.speaker // models.dit_cfg.speaker_patch_size,
              f"static K/V {tuple(pre.kv_static[0].shape)} hold a latent "
              "segment")
        return pre

    def sampler_stage(model, key):
        latents, runs[key + "_ms"] = timed(
            lambda: stages.sampler(model, plan, pre, inputs, dt), key)
        check(finite(latents), "latents not finite")
        return latents

    def decode_stage():
        audio, runs["decode_ms"] = timed(lambda: ae_decode(one_shot, latents),
                                         "decode")
        check(finite(audio), "audio not finite")

    def short_stage():
        (latents, audio), runs["p50_short_ms"] = timed(
            lambda: generate(one_shot, inputs, short, steps), "p50_short")
        check(finite(latents, audio) and audio.shape == (1, short * spl),
              f"audio {tuple(audio.shape)} finite {finite(audio)}")

    def int8_stage():
        qdit = quantize_dit(one_shot.dit)
        sampler_stage(qdit, "sampler_int8")
        check(dit_is_quantized(qdit) and not dit_is_quantized(one_shot.dit),
              "quantize_dit changed the bf16 DiT")

    stage("one_shot", one_shot_stage)
    pre = stage("prefill", prefill_stage)
    latents = stage("sampler", sampler_stage, one_shot.dit, "sampler")
    stage("decode", decode_stage)
    stage("p50_short", short_stage)
    stage("sampler_int8", int8_stage)
    # free the one-shot set before the blockwise and batched stages
    del one_shot, pre, latents
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    spk_np = inputs["speaker_latent"].cpu().numpy()
    spk_mask_np = inputs["speaker_mask"].cpu().numpy()

    def stream_stage():
        n = args.reps or REPS["stream"]
        for _ in range(args.warmup):
            stages.stream_once(models, spk_np, stream_blocks, kw, spk_mask_np)
        out = []
        for _ in range(n):
            chunks = []
            out.append(stages.stream_once(models, spk_np, stream_blocks, kw,
                                          spk_mask_np, audio=chunks))
        runs["ttfa_ms"] = [1e3 * r[0] for r in out]
        stream_s = stages.audio_seconds(models, sum(stream_blocks))
        runs["streamed_rtf"] = [stream_s / r[1] for r in out]
        check(len(chunks) == len(stream_blocks)
              and sum(c.shape[-1] for c in chunks) == sum(stream_blocks) * spl
              and all(np.isfinite(c).all() for c in chunks),
              f"{len(chunks)} blocks of {[c.shape for c in chunks]}")

    def serve_stage():
        tmp = tempfile.mkdtemp(prefix="echo_bench_serve_")
        try:
            voices = os.path.join(tmp, "voices")
            os.makedirs(voices)
            rng = np.random.default_rng(VOICE_SEED)
            voice = (0.1 * rng.standard_normal((1, lengths.speaker * spl))
                     ).astype(np.float32)
            audio_io.write_wav(os.path.join(voices, "bench.wav"), voice,
                               models.dac_cfg.sample_rate)
            cfg = load_config({"AUDIO_VOICES_DIR": voices,
                               "OUTPUT_AUDIO_DIR": os.path.join(tmp, "out"),
                               "HF_TOKEN": "x", "ECHO_DEVICE": dev.type})
            job = {"text": stages.STREAM_TEXT, "stream": True,
                   "chunk_sizes": list(serve_blocks), "seed": 0,
                   "speaker_voice": "bench.wav", "parameters": dict(kw)}
            for _ in range(args.warmup):    # the voice's encode, cached
                serve_once(models, job, cfg)
            out = [serve_once(models, job, cfg)
                   for _ in range(args.reps or REPS["serve"])]
            runs["ttfa_serve_ms"] = [1e3 * r[0] for r in out]
            events = out[-1][1]
            blocks = [e for e in events if e.get("event") == "block"]
            samples = sum(audio_io.read_wav(e["local_path"])[0].shape[-1]
                          for e in blocks)
            check(len(blocks) == len(serve_blocks)
                  and blocks[-1]["latent_end"] == sum(serve_blocks)
                  and samples == sum(serve_blocks) * spl
                  and events[-1].get("status") == "success",
                  f"{len(blocks)} block events, {samples} samples, final "
                  f"{events[-1].get('status')}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def batch_stage():
        requests = [BatchRequest(text=t, seed=100 + i, speaker_latent=spk_np)
                    for i, t in enumerate(stages.BATCH_TEXTS)]
        results, runs["batch"] = timed(lambda: run_batch(
            models, requests, sampler_params=dict(kw, sequence_length=seq)),
            "batch")
        check(len(results) == BATCH
              and all(np.isfinite(r.audio).all() for r in results),
              f"{len(results)} results")

    def b8_stage():
        inputs8 = batch_inputs(inputs, seq)
        (latents8, audio8), runs["b8_chip"] = timed(
            lambda: b8_stages(models, inputs8, plan), "b8_chip")
        check(finite(latents8, *audio8)
              and [tuple(a.shape) for a in audio8]
              == [(BATCH // 2, seq * spl)] * 2, "audio not finite")

    stage("stream", stream_stage)
    stage("serve", serve_stage)
    stage("batch", batch_stage)
    stage("b8_chip", b8_stage)

    runs["value"] = [audio_s / (ms / 1e3) for ms in runs["value"]]
    runs["throughput_rtf_b8"] = [BATCH * audio_s / (ms / 1e3)
                                 for ms in runs.pop("batch")]
    runs["throughput_rtf_b8_chip"] = [BATCH * audio_s / (ms / 1e3)
                                      for ms in runs.pop("b8_chip")]
    m = {k: stages.median(v) for k, v in runs.items()}
    rtf_int8 = audio_s / ((m["prefill_ms"] + m["sampler_int8_ms"]
                           + m["decode_ms"]) / 1e3)
    return {
        "metric": "rtf_audio_sec_per_sec_per_chip",
        "value": round(m["value"], 3),
        "unit": "x_realtime",
        "vs_baseline": round(m["value"] / BASELINE_RTF, 3),
        "prefill_ms": round(m["prefill_ms"], 1),
        "sampler_ms": round(m["sampler_ms"], 1),
        "decode_ms": round(m["decode_ms"], 1),
        "p50_short_ms": round(m["p50_short_ms"], 1),
        "ttfa_ms": round(m["ttfa_ms"], 1),
        "ttfa_serve_ms": round(m["ttfa_serve_ms"], 1),
        "streamed_rtf": round(m["streamed_rtf"], 3),
        "throughput_rtf_b8": round(m["throughput_rtf_b8"], 3),
        "throughput_rtf_b8_chip": round(m["throughput_rtf_b8_chip"], 3),
        "sampler_int8_ms": round(m["sampler_int8_ms"], 1),
        "rtf_int8": round(rtf_int8, 3),
        "ranges": {k: stages.span(v) for k, v in runs.items()},
    }


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, reps=None)
    args, models, lengths = stages.setup(ap, argv, models)
    try:
        line = run(args, models, lengths)
    except StageFailed as exc:
        traceback.print_exception(exc.__cause__, file=sys.stderr)
        print(f"bench: stage {exc}", file=sys.stderr, flush=True)
        return 1
    return stages.emit(line, models.device)


if __name__ == "__main__":
    sys.exit(main())
