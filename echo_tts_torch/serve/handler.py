"""Serverless-style request handler.

Counterpart of echo_tts_tpu/serve/handler.py.  Re-implements the reference
worker's request contract (reference: handler.py:682-861) on the port:

  handler({"input": {...}}) -> dict

  synthesis input: {"text": str (<=4000 chars), "speaker_voice": filename?,
                    "parameters": {...sampler params...}, "preset"?,
                    "seed": int?, "session_id": str?, "boundary_mode":
                    "normalize"|"crossfade"|"none",
                    "max_chars_per_chunk": int?, "target_chunk_duration": s?,
                    "auto_sequence_length": bool?}
  streaming:       {"text": ..., "stream": true, "chunk_size"?,
                    "num_chunks"?, "chunk_sizes"?} -> per-block WAVs as they
                    are produced (the stdin protocol emits one JSON line
                    per block)
  health check:    {"action": "health_check"}
  metrics:         {"action": "metrics"}

Per-chunk seeds advance seed + idx*1000 (reference: handler.py:749); chunk
boundaries go through normalize_chunk_boundaries / crossfade_chunks
(reference: handler.py:763-768); the error envelope returns
{error, error_type, traceback} (reference: handler.py:797-803).

The models load on `ServeConfig.device` (ECHO_DEVICE, default "cuda"):
without a card the default raises, and the CPU runs only when asked.
With ECHO_COORD set, `main` first joins the world of one process per card
(parallel/distributed.py) and each rank then serves on its own card, the
share-nothing stance of the reference's workers.  The JAX handler's
`--warmup-full` (the whole XLA shape manifest) has no counterpart:
nothing here compiles per shape.
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time
import traceback
import uuid
import weakref
from typing import Dict, List, Optional

import numpy as np

from ..config import SAMPLER_DEFAULTS
from ..pipeline import audio_io, dsp
from ..pipeline.pipeline import EchoModels, euler_sample_fn, sample_pipeline
from ..utils.profiling import StageTimer
from . import metrics
from . import models as models_mod
from .config import (AUDIO_EXTENSIONS, ServeConfig, device_info, load_config,
                     scan_voices)
# bound here so that tests can shrink them via monkeypatch on this module
from .presets import MAX_STREAM_CHUNKS, STREAM_CHUNK_SIZES
from .storage import sanitize_component, save_and_upload_audio

log = logging.getLogger("echo_tts_torch.serve")

MAX_TEXT_CHARS = 4000       # reference: handler.py:690-698
SAMPLE_RATE = 44100
SEED_STRIDE = 1000          # reference: handler.py:749

# Voice-latent cache: encoding a reference voice costs one AE encode per
# 640-latent chunk, but serving traffic reuses a small library of voice
# files (reference: handler.py:711-718 voices dir).  The encoded
# (latent, mask, bucket) is cached per (bundle, path, mtime, size): repeat
# requests skip the encode.  LRU-bounded.
VOICE_CACHE_MAX = 16
_VOICE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_VOICE_CACHE_LOCK = threading.Lock()


def clear_voice_cache() -> None:
    with _VOICE_CACHE_LOCK:
        _VOICE_CACHE.clear()


def models_frame_length(models: EchoModels) -> int:
    return models.dac_cfg.frame_length


def get_voice_latent(models: EchoModels, path: str):
    """(speaker_latent, speaker_mask, bucket) for a voice file, cached.
    The latent is padded to its speaker bucket (serve/presets.py:
    pick_speaker_bucket) with the mask carrying the true length, so one
    cache entry feeds every request path (one-shot, stream, batch).
    mtime + size key the entry: replacing the file re-encodes.  The
    bundle's identity is part of the key (latents are valid only for the
    encoder that made them), guarded by a weakref against id() reuse, and
    models.clear_models() clears the cache too."""
    from ..pipeline import pipeline as pl
    from .presets import pick_speaker_bucket

    st = os.stat(path)
    key = (id(models), os.path.abspath(path), st.st_mtime_ns, st.st_size,
           models_frame_length(models))
    with _VOICE_CACHE_LOCK:
        hit = _VOICE_CACHE.get(key)
        # a bundle freed and replaced at the same address must miss
        if hit is not None and hit[0]() is models:
            _VOICE_CACHE.move_to_end(key)
            return hit[1]
    audio = audio_io.load_audio(path)
    n_latents = audio.shape[-1] // models_frame_length(models)
    bucket = pick_speaker_bucket(n_latents)
    lat, mask = pl.get_speaker_latent_and_mask(
        models, audio, max_speaker_latent_length=bucket, pad_to_max=True)
    with _VOICE_CACHE_LOCK:
        _VOICE_CACHE[key] = (weakref.ref(models), (lat, mask, bucket))
        while len(_VOICE_CACHE) > VOICE_CACHE_MAX:
            _VOICE_CACHE.popitem(last=False)
    log.info("voice cached: %s (bucket %d, %d entries)",
             os.path.basename(path), bucket, len(_VOICE_CACHE))
    return lat, mask, bucket


def build_sample_fn(parameters: Optional[Dict] = None,
                    preset: Optional[str] = None):
    """A sample_fn over the Euler sampler with the request's parameters
    over the defaults (reference: handler.py:426-443); an optional named
    preset (serve/sampler_presets.json) supplies a base that explicit
    parameters override.  Its starting noise comes from a torch.Generator
    seeded with the chunk's seed (pipeline.euler_sample_fn)."""
    p = dict(SAMPLER_DEFAULTS)
    if preset:
        from .presets import get_preset
        p.update(get_preset(preset))
    unknown = set(parameters or ()) - set(p)
    if unknown:
        raise ValueError(f"unknown sampler parameters: {sorted(unknown)}")
    p.update(parameters or {})

    def sample_fn(models: EchoModels, speaker_latent, speaker_mask,
                  text_ids, text_mask, rng_seed: int):
        return euler_sample_fn(models, speaker_latent, speaker_mask,
                               text_ids, text_mask, rng_seed, **p)

    return sample_fn, p


def _resolve_voice(cfg: ServeConfig, speaker_voice: str) -> str:
    """Path-traversal + extension checks (reference: handler.py:711-718)."""
    name = os.path.basename(speaker_voice)
    if name != speaker_voice or speaker_voice.startswith("."):
        raise ValueError("invalid speaker_voice: path components not allowed")
    if not name.lower().endswith(AUDIO_EXTENSIONS):
        raise ValueError(
            f"invalid speaker_voice extension; allowed: {AUDIO_EXTENSIONS}")
    path = os.path.join(cfg.voices_dir, name)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"voice file not found: {name}")
    return path


def _load(cfg: ServeConfig, allow_random: bool) -> EchoModels:
    return models_mod.load_models(cfg.model_dir, device=cfg.device,
                                  allow_random=allow_random)


def health_check(cfg: Optional[ServeConfig] = None,
                 batch_server=None) -> Dict:
    """Operational status without synthesis (reference:
    handler.py:609-679), with the metrics snapshot and, in concurrent
    mode, the micro-batch server's queue stats (serve/server.py)."""
    cfg = cfg or load_config()
    voices = scan_voices(cfg.voices_dir)
    out = {
        "status": "healthy" if not cfg.issues else "degraded",
        "config_issues": cfg.issues,
        "models_loaded": models_mod.models_loaded(),
        "device": device_info(),
        "s3_configured": cfg.s3_configured,
        "voices_dir": cfg.voices_dir,
        "voices_available": voices,
        "output_dir": cfg.output_dir,
        "ffmpeg": audio_io.ffmpeg_available(),
        # which DiT the worker serves (bf16 parity vs W8A8 non-parity),
        # read from the loaded modules (serve/models.py)
        "dit_quant": models_mod.served_quant_mode(),
        "metrics": metrics.snapshot(),
    }
    if batch_server is not None:
        out["batch_queue"] = batch_server.stats()
    return out


def synthesize(job_input: Dict, cfg: Optional[ServeConfig] = None,
               models: Optional[EchoModels] = None,
               batch_server=None) -> Dict:
    """Main synthesis path (reference: handler.py:682-803).

    With `batch_server` (a serve.server.MicroBatchServer), the request's
    chunks are submitted to the shared micro-batching executor instead of
    running inline: concurrent requests' chunks coalesce into one (G*B)-row
    sampler pass (serve/batcher.py).  Everything around the sampler
    (validation, chunking, voice encode-once, boundary DSP, upload,
    metadata) is the same in both modes, and each request starts from the
    same noise either way (per-request seeds, masks with true lengths)."""
    # sanitize user-controlled filename components before any synthesis
    # work: failing at upload time would waste the whole generation
    request_id = sanitize_component(
        job_input.get("request_id") or uuid.uuid4().hex[:12], "request_id")
    if job_input.get("session_id") is not None:
        sanitize_component(job_input["session_id"], "session_id")
    t_start = time.time()
    timer = StageTimer()
    cfg = cfg or load_config()

    text = job_input.get("text")
    if not text or not isinstance(text, str):
        raise ValueError("'text' is required")
    if len(text) > MAX_TEXT_CHARS:
        raise ValueError(
            f"text too long: {len(text)} > {MAX_TEXT_CHARS} chars")

    boundary_mode = job_input.get("boundary_mode", "normalize")
    if boundary_mode not in ("normalize", "crossfade", "none"):
        raise ValueError(f"unknown boundary_mode: {boundary_mode}")

    sample_fn, sample_params = build_sample_fn(
        job_input.get("parameters"), preset=job_input.get("preset"))

    if models is None:
        with timer.stage("model_load"):
            models = _load(cfg, bool(job_input.get("_allow_random")))

    voice_path = None
    voice_name = job_input.get("speaker_voice")
    if voice_name:
        # existence/traversal checks fail fast; the (cached) encode runs
        # after text chunking so that bad text never pays an encode
        voice_path = _resolve_voice(cfg, voice_name)

    from ..pipeline.text import chunk_text_for_audio

    chunks = chunk_text_for_audio(
        text,
        max_chars=int(job_input.get("max_chars_per_chunk", 300)),
        target_duration_seconds=float(
            job_input.get("target_chunk_duration", 10.0)))
    if not chunks:
        raise ValueError("text is empty after normalization")

    # Optional latency feature: bound each chunk's generation length by the
    # text's estimated duration (bucketed) instead of the reference's
    # always-640-then-crop.  Off by default: it changes the outputs for a
    # given seed.
    auto_seq = bool(job_input.get("auto_sequence_length", False))

    seed = int(job_input.get("seed", 0))

    # the voice is encoded ONCE for the whole request, through the voice
    # cache (bucket-padded, serve/presets.py)
    spk_latent = spk_mask = None
    if voice_path is not None:
        with timer.stage("voice_encode"):
            if batch_server is not None:
                # an uncached encode is device work on a pool thread: take
                # the server's device lock so that it never runs beside a
                # batch pass or a stream; a second thread racing on the
                # same voice waits here and then hits the cache
                with batch_server.device_lock:
                    spk_latent, spk_mask, _ = get_voice_latent(
                        models, voice_path)
            else:
                spk_latent, spk_mask, _ = get_voice_latent(models,
                                                           voice_path)

    audio_chunks: List[np.ndarray] = []
    if batch_server is not None:
        # submit every chunk up front, so that this request's chunks
        # coalesce with other requests' in the executor, then gather in
        # order; seeds and the voice latent are the serial loop's
        from .batcher import BatchRequest
        futs = []
        for idx, chunk in enumerate(chunks):
            chunk_params = dict(sample_params)
            if auto_seq:
                from .presets import pick_sequence_bucket
                chunk_params["sequence_length"] = pick_sequence_bucket(
                    chunk, sample_params["sequence_length"])
            futs.append(batch_server.submit(
                BatchRequest(text=chunk, seed=seed + idx * SEED_STRIDE,
                             speaker_latent=spk_latent,
                             speaker_mask=spk_mask,
                             request_id=f"{request_id}:{idx}"),
                chunk_params))
        with timer.stage("synthesis"):
            for idx, fut in enumerate(futs):
                res = fut.result()
                audio_chunks.append(np.asarray(res.audio))
                log.info("[%s] chunk %d/%d done (%.1fs audio, batched)",
                         request_id, idx + 1, len(chunks),
                         res.audio.shape[-1] / SAMPLE_RATE)
    else:
        for idx, chunk in enumerate(chunks):
            chunk_fn = sample_fn
            if auto_seq:
                from .presets import pick_sequence_bucket
                bucket = pick_sequence_bucket(
                    chunk, sample_params["sequence_length"])
                chunk_fn, _ = build_sample_fn(
                    {**(job_input.get("parameters") or {}),
                     "sequence_length": bucket},
                    preset=job_input.get("preset"))
            with timer.stage("synthesis"):
                chunk_audio, _ = sample_pipeline(
                    models, chunk_fn, chunk, None,
                    rng_seed=seed + idx * SEED_STRIDE,
                    speaker_latent=spk_latent, speaker_mask=spk_mask)
            audio_chunks.append(np.asarray(chunk_audio))
            log.info("[%s] chunk %d/%d done (%.1fs audio)", request_id,
                     idx + 1, len(chunks),
                     chunk_audio.shape[-1] / SAMPLE_RATE)

    with timer.stage("host_dsp"):
        if len(audio_chunks) == 1 or boundary_mode == "none":
            audio = np.concatenate(audio_chunks, axis=-1)
        elif boundary_mode == "crossfade":
            audio = dsp.crossfade_chunks(audio_chunks)
        else:  # "normalize" (validated above)
            audio = dsp.normalize_chunk_boundaries(audio_chunks)

    if audio.ndim == 1:
        audio = audio[None, :]

    with timer.stage("encode_upload"):
        upload = save_and_upload_audio(
            audio, SAMPLE_RATE, cfg, request_id,
            session_id=job_input.get("session_id"))

    gen_seconds = time.time() - t_start
    rtf = round((audio.shape[-1] / SAMPLE_RATE) / max(gen_seconds, 1e-9), 4)
    stage_timings = timer.report()
    for stage, rep in stage_timings.items():
        metrics.histogram(f"stage_{stage}_seconds").observe(rep["seconds"])
    metrics.histogram("request_seconds").observe(gen_seconds)
    metrics.histogram("rtf").observe(rtf)

    return {
        "status": "success",
        **upload,
        "metadata": {
            "request_id": request_id,
            "sample_rate": SAMPLE_RATE,
            "duration_seconds": round(audio.shape[-1] / SAMPLE_RATE, 3),
            "num_chunks": len(chunks),
            "seed": seed,
            "sampler": sample_params,
            "speaker_voice": voice_name,
            "device": models.device.type,
            "generation_time_seconds": round(gen_seconds, 3),
            "stage_timings": stage_timings,
            "rtf": rtf,
        },
    }


def iter_synthesize_stream(job_input: Dict,
                           cfg: Optional[ServeConfig] = None,
                           models: Optional[EchoModels] = None):
    """Generator form of the streaming job: yields one {"event": "block",
    ...} dict per produced audio block (its WAV already on disk), then the
    final {"event": "final", ...} envelope, the shape that runpod's
    generator-handler protocol and the stdin protocol both need.

    input: {"text", "stream": true, "speaker_voice"?, "seed"?,
            "chunk_size"? in STREAM_CHUNK_SIZES (default 160),
            "num_chunks"? 1..MAX_STREAM_CHUNKS (default 4),
            "chunk_sizes"? explicit per-block schedule (each in
            STREAM_CHUNK_SIZES; overrides chunk_size/num_chunks, e.g.
            [40, 80, 160, 320] for early first audio), "preset"?,
            "parameters"? (sampler params sans sequence_length),
            "session_id"?}
    The reference has no streaming serving path: this is the JAX
    package's addition on its blockwise sampler (serve/streaming.py).
    Under ECHO_DIT_QUANT=int8 the stream runs the W8A8 DiT."""
    from .streaming import stream_synthesize

    request_id = job_input.get("request_id") or uuid.uuid4().hex[:12]
    request_id = sanitize_component(request_id, "request_id")
    session_id = job_input.get("session_id")
    if session_id is not None:
        session_id = sanitize_component(session_id, "session_id")
    t_start = time.time()
    cfg = cfg or load_config()

    text = job_input.get("text")
    if not text or not isinstance(text, str):
        raise ValueError("'text' is required")
    if len(text) > MAX_TEXT_CHARS:
        raise ValueError(
            f"text too long: {len(text)} > {MAX_TEXT_CHARS} chars")

    chunk_size = int(job_input.get("chunk_size", 160))
    if chunk_size not in STREAM_CHUNK_SIZES:
        raise ValueError(
            f"chunk_size must be one of {STREAM_CHUNK_SIZES} (the serving "
            "block sizes)")
    num_chunks = int(job_input.get("num_chunks", 4))
    if not 1 <= num_chunks <= MAX_STREAM_CHUNKS:
        raise ValueError(
            f"num_chunks must be in [1, {MAX_STREAM_CHUNKS}]")
    chunk_sizes = job_input.get("chunk_sizes")
    if chunk_sizes is not None:
        chunk_sizes = [int(c) for c in chunk_sizes]
        if not chunk_sizes or len(chunk_sizes) > MAX_STREAM_CHUNKS:
            raise ValueError(
                f"chunk_sizes must have 1..{MAX_STREAM_CHUNKS} entries")
        bad = [c for c in chunk_sizes if c not in STREAM_CHUNK_SIZES]
        if bad:
            raise ValueError(
                f"chunk_sizes entries must be in {STREAM_CHUNK_SIZES} "
                f"(the serving block sizes), got {bad}")

    # preset + parameter validation/merge shared with the one-shot path
    _, params = build_sample_fn(job_input.get("parameters"),
                                preset=job_input.get("preset"))
    params = dict(params)
    params.pop("sequence_length", None)

    if models is None:
        models = _load(cfg, bool(job_input.get("_allow_random")))

    spk_latent = spk_mask = None
    voice_name = job_input.get("speaker_voice")
    if voice_name:
        # cached and bucket-padded, as on the one-shot path
        spk_latent, spk_mask, _ = get_voice_latent(
            models, _resolve_voice(cfg, voice_name))

    out_dir = (os.path.join(cfg.output_dir, session_id) if session_id
               else cfg.output_dir)
    os.makedirs(out_dir, exist_ok=True)

    blocks = []
    pieces = []
    for chunk in stream_synthesize(
            models, text, None, chunk_size=chunk_size,
            num_chunks=num_chunks, chunk_sizes=chunk_sizes,
            seed=int(job_input.get("seed", 0)),
            sampler_params=params, speaker_latent=spk_latent,
            speaker_mask=spk_mask):
        path = os.path.join(
            out_dir, f"{request_id}_block{chunk.index:03d}.wav")
        audio_io.write_wav(path, chunk.audio, SAMPLE_RATE)
        info = {
            "event": "block",
            "request_id": request_id,
            "index": chunk.index,
            "local_path": path,
            "latent_start": chunk.latent_start,
            "latent_end": chunk.latent_end,
            "duration_seconds": round(chunk.audio.shape[-1] / SAMPLE_RATE,
                                      3),
            "is_last": chunk.is_last,
            "elapsed_seconds": round(time.time() - t_start, 3),
        }
        if not blocks:  # first audio out of the door: the stream's TTFA
            metrics.histogram("ttfa_seconds").observe(
                info["elapsed_seconds"])
        blocks.append(info)
        pieces.append(chunk.audio)
        yield info

    audio = np.concatenate(pieces, axis=-1)
    # the final artifact goes through the same Opus/S3 path as batch jobs
    upload = save_and_upload_audio(audio, SAMPLE_RATE, cfg, request_id,
                                   session_id=session_id)
    total = time.time() - t_start
    metrics.histogram("stream_seconds").observe(total)
    metrics.histogram("streamed_rtf").observe(
        round((audio.shape[-1] / SAMPLE_RATE) / max(total, 1e-9), 4))
    yield {
        "event": "final",
        "status": "success",
        **upload,
        "blocks": blocks,
        "metadata": {
            "request_id": request_id,
            "sample_rate": SAMPLE_RATE,
            "duration_seconds": round(audio.shape[-1] / SAMPLE_RATE, 3),
            "num_blocks": len(blocks),
            "seed": int(job_input.get("seed", 0)),
            "sampler": params,
            "speaker_voice": voice_name,
            "device": models.device.type,
            "generation_time_seconds": round(total, 3),
            "first_block_seconds": blocks[0]["elapsed_seconds"],
            "rtf": round((audio.shape[-1] / SAMPLE_RATE)
                         / max(total, 1e-9), 4),
        },
    }


def synthesize_stream(job_input: Dict, cfg: Optional[ServeConfig] = None,
                      models: Optional[EchoModels] = None,
                      on_block=None) -> Dict:
    """Blocking wrapper over iter_synthesize_stream: fires on_block per
    block and returns the final envelope."""
    final = None
    for event in iter_synthesize_stream(job_input, cfg=cfg, models=models):
        if event.get("event") == "block":
            if on_block is not None:
                on_block(event)
        else:
            final = event
    return final


def _error_envelope(exc: Exception) -> Dict:
    return {"error": str(exc), "error_type": type(exc).__name__,
            "traceback": traceback.format_exc()}


def handler(job: Dict, on_block=None, batch_server=None,
            cfg: Optional[ServeConfig] = None) -> Dict:
    """Queue-worker entry point (reference: handler.py:806-816).
    `batch_server` routes synthesis jobs through the shared micro-batching
    executor (see synthesize); streaming jobs always run serially, since
    their latency contract is per block, not per request.  `cfg`
    (optional) avoids re-reading the environment per job."""
    try:
        job_input = job.get("input") or {}
        action = job_input.get("action")
        if action == "health_check":
            return health_check(cfg, batch_server=batch_server)
        if action == "metrics":
            # a metrics-only poll: cheaper than a health check (no
            # directory scan, no device query)
            out = {"metrics": metrics.snapshot()}
            if batch_server is not None:
                out["batch_queue"] = batch_server.stats()
            return out
        metrics.counter("requests_total").inc()
        if job_input.get("stream"):
            return synthesize_stream(job_input, cfg=cfg, on_block=on_block)
        return synthesize(job_input, cfg=cfg, batch_server=batch_server)
    except Exception as exc:
        metrics.counter("errors_total").inc()
        metrics.counter(f"errors_{type(exc).__name__}").inc()
        return _error_envelope(exc)
    finally:
        if cfg is not None and cfg.metrics_file:
            try:
                extra = ({"batch_queue": batch_server.stats()}
                         if batch_server is not None else None)
                metrics.write_metrics_file(cfg.metrics_file, extra=extra)
            except OSError as exc:  # never fail a job on metrics IO
                log.warning("metrics file write failed: %r", exc)


def handler_generator(job: Dict):
    """Generator entry point for runpod's streaming protocol (opt-in:
    `runpod.serverless.start({"handler": handler_generator,
    "return_aggregate_stream": True})` delivers per-block events over
    /stream, but also turns every aggregated output into a one-element
    list of the envelope).  The default deployment keeps the dict-shaped
    `handler` contract."""
    try:
        job_input = job.get("input") or {}
        if job_input.get("action") == "health_check":
            yield health_check()
        elif job_input.get("stream"):
            yield from iter_synthesize_stream(job_input)
        else:
            yield synthesize(job_input)
    except Exception as exc:
        yield _error_envelope(exc)


def warmup_compile(models: EchoModels,
                   parameters: Optional[Dict] = None) -> None:
    """Get the worker ready for traffic: build the three hand-written
    kernels (ops/cuda_build: one nvcc per source, 35-50 s on first use,
    cached in the build directory by a hash of the sources) and answer one
    short request through the one-shot path.  This is what the port
    compiles: an eager PyTorch program has no per-shape programs to warm,
    which is why the JAX package's warm-up manifest has no counterpart
    here."""
    from ..ops import cuda_build

    t0 = time.time()
    if models.device.type == "cuda":
        secs = cuda_build.build()
        log.info("kernels built: %s", secs)
    sample_fn, _ = build_sample_fn(parameters)
    sample_pipeline(models, sample_fn, "Warmup utterance.", None, rng_seed=0)
    log.info("warm-up: %.1fs", time.time() - t0)


def serve_stdin_concurrent(cfg: ServeConfig, *, max_batch: int,
                           allow_random: bool = False,
                           lines=None, emit=None) -> None:
    """Concurrent stdin/stdout protocol: synthesis jobs run on a thread
    pool and their chunks coalesce in one MicroBatchServer (one device
    stream, bounded device memory; serve/server.py); streaming jobs run on
    a dedicated single worker that holds the server's device_lock for the
    stream's duration, so that a stream never runs beside a batch pass
    (batch work queues behind an active stream).  Responses carry
    request_id; completion order is NOT input order.  `lines`/`emit` exist
    for tests; production uses stdin/print."""
    import json
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from .server import MicroBatchServer

    models = _load(cfg, allow_random)
    server = MicroBatchServer(models, max_batch=max_batch)
    if emit is None:
        _lock = threading.Lock()

        def emit(obj):
            with _lock:
                print(json.dumps(obj), flush=True)

    pool = ThreadPoolExecutor(max_workers=max_batch,
                              thread_name_prefix="echo-job")
    stream_pool = ThreadPoolExecutor(max_workers=1,
                                     thread_name_prefix="echo-stream")

    def run_stream(j):
        with server.device_lock:
            emit(handler(j, on_block=emit, cfg=cfg))

    pending = []
    try:
        for line in (lines if lines is not None else sys.stdin):
            line = line.strip() if isinstance(line, str) else line
            if not line:
                continue
            if isinstance(line, str):
                try:
                    job = json.loads(line)
                except json.JSONDecodeError as exc:
                    emit({"error": f"invalid JSON: {exc}",
                          "error_type": "JSONDecodeError", "traceback": ""})
                    continue
            else:
                job = line
            job_input = job.get("input") or {}
            if job_input.get("stream"):
                pending.append(stream_pool.submit(run_stream, job))
            else:
                pending.append(pool.submit(
                    lambda j=job: emit(handler(j, batch_server=server,
                                               cfg=cfg))))
            # drop finished futures so that a long-lived worker's list
            # stays O(in flight); handler() envelopes job errors, so an
            # exception here means emit itself failed, which is logged
            still = []
            for f in pending:
                if not f.done():
                    still.append(f)
                elif f.exception() is not None:
                    log.error("response emit failed: %r", f.exception())
            pending = still
        for f in pending:
            try:
                f.result()
            except Exception as exc:  # as in the mid-run drain
                log.error("response emit failed: %r", exc)
    finally:
        pool.shutdown(wait=True)
        stream_pool.shutdown(wait=True)
        server.shutdown()


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: `--warmup` loads the models then exits (reference:
    handler.py:822-861); `--warmup-compile` also builds the kernels and
    answers one short request (warmup_compile).  Otherwise starts the
    runpod worker when runpod is installed, else serves stdin/stdout JSON
    lines: serially by default, or with `--concurrent N` /
    ECHO_CONCURRENT=N through the micro-batching executor
    (serve_stdin_concurrent).  ECHO_DEVICE=cpu runs on the CPU."""
    import argparse
    import json
    import sys

    parser = argparse.ArgumentParser()
    parser.add_argument("--warmup", action="store_true")
    parser.add_argument("--warmup-compile", action="store_true")
    parser.add_argument("--allow-random-weights", action="store_true")
    parser.add_argument(
        "--concurrent", type=int,
        default=int(os.environ.get("ECHO_CONCURRENT", "0")),
        help="coalesce up to N concurrent synthesis jobs per device batch "
             "(stdin protocol; 0 = serial, matching the reference worker)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    # a multi-card world: join it before the models load, so that this
    # rank's card is the current device (parallel/distributed.py)
    from ..parallel.distributed import initialize_from_env
    if initialize_from_env():
        import torch.distributed as dist
        log.info("joined the process group: rank %d/%d (%s)",
                 dist.get_rank(), dist.get_world_size(), dist.get_backend())

    cfg = load_config()
    for issue in cfg.issues:
        log.warning("config: %s (starting anyway)", issue)

    if args.warmup or args.warmup_compile:
        models = _load(cfg, args.allow_random_weights)
        if args.warmup_compile:
            warmup_compile(models)
        log.info("warmup complete")
        return

    try:
        import runpod
    except ImportError:
        runpod = None
    if runpod is not None:
        # the dict-shaped contract (as the reference worker); streaming
        # jobs still write block WAVs progressively under this handler
        runpod.serverless.start({"handler": handler})
        return
    if args.concurrent > 0:
        log.info("runpod not installed; serving JSON lines on stdin "
                 "with micro-batching (max_batch=%d)", args.concurrent)
        serve_stdin_concurrent(cfg, max_batch=args.concurrent,
                               allow_random=args.allow_random_weights)
        return
    log.info("runpod not installed; serving JSON lines on stdin")
    if args.allow_random_weights:
        # load once here, so that every job is served by the random
        # bundle without asking for it per job
        _load(cfg, True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            job = json.loads(line)
        except json.JSONDecodeError as exc:
            print(json.dumps({"error": f"invalid JSON: {exc}",
                              "error_type": "JSONDecodeError",
                              "traceback": ""}), flush=True)
            continue
        # streaming jobs emit one JSON line per audio block as it is
        # produced, then the final envelope
        out = handler(job, cfg=cfg,
                      on_block=lambda b: print(json.dumps(b), flush=True))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
