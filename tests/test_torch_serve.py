"""The port's serving layer (echo_tts_torch/serve/, utils/profiling.py)
against the JAX package's on the CPU: config, voice scan and device report;
the metrics registry (the cases of tests/test_metrics.py); storage; the
sampler presets and the buckets; StageTimer and trace(); the handler's
envelopes and error types for the same jobs, the seed stride, the voice
cache, the metrics action, streaming jobs (the W8A8 DiT included) and the
serving codec's ECHO_SNAKE_APPROX.

The models are the JAX package's tiny fp32 weights, bridged into the port
(tools/bridge.py); sampler parameters are cut to 2 steps of 8 latents.
"""
import dataclasses
import json
import os
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

from echo_tts_tpu.serve import handler as jh
from echo_tts_tpu.serve import presets as jpresets
from echo_tts_tpu.serve.config import load_config as j_load_config

from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
from echo_tts_torch.ops.quant import quantize_dit
from echo_tts_torch.pipeline import audio_io
from echo_tts_torch.pipeline import pipeline as tpl
from echo_tts_torch.serve import config as tconfig
from echo_tts_torch.serve import handler as th
from echo_tts_torch.serve import metrics
from echo_tts_torch.serve import models as tmodels
from echo_tts_torch.serve import presets as tpresets
from echo_tts_torch.serve import storage
from echo_tts_torch.tools import bridge
from echo_tts_torch.utils.profiling import StageTimer, trace

torch.set_num_threads(1)
DIT_CFG, DAC_CFG = tiny_dit_config(), tiny_dac_config()
FAST = {"num_steps": 2, "sequence_length": 8}
VOICE = os.path.join(os.path.dirname(__file__), "data", "voice.wav")
TWO_CHUNKS = ("First sentence of a long passage here. " * 2
              + "\n\n" + "Second paragraph follows right here. " * 2)


def port_models(jm):
    """The JAX bundle's weights in the port, fp32 on the CPU."""
    return tpl.EchoModels(
        dit=bridge.load_dit_state(
            bridge.dit_state_from_jax(jax.tree.map(np.asarray, jm.dit_params),
                                      DIT_CFG),
            DIT_CFG, device="cpu", dtype=torch.float32),
        dac=bridge.load_dac_state(
            bridge.dac_state_from_jax(jax.tree.map(np.asarray, jm.dac_params),
                                      DAC_CFG),
            DAC_CFG, device="cpu"),
        pca=bridge.pca_state(jax.tree.map(np.asarray, jm.pca), device="cpu"),
        dtype=torch.float32)


@pytest.fixture(scope="module")
def pair(tiny_models):
    return tiny_models, port_models(tiny_models)


@pytest.fixture
def env(tmp_path):
    voices = tmp_path / "voices"
    voices.mkdir()
    return {"AUDIO_VOICES_DIR": str(voices),
            "OUTPUT_AUDIO_DIR": str(tmp_path / "out"),
            "HF_TOKEN": "test", "ECHO_DEVICE": "cpu"}


@pytest.fixture
def cfg(env):
    return tconfig.load_config(env)


@pytest.fixture(autouse=True)
def fresh_state():
    metrics.reset()
    th.clear_voice_cache()
    yield
    metrics.reset()
    th.clear_voice_cache()
    tmodels.clear_models()


# ---------------------------------------------------------------------------
# config, voices, device report
# ---------------------------------------------------------------------------

def test_load_config_matches_jax(env, tmp_path):
    for e in (env, {"S3_BUCKET_NAME": "b", "AUDIO_VOICES_DIR": "/nonexistent"},
              {**env, "ECHO_MODEL_DIR": str(tmp_path), "S3_BUCKET": "b",
               "S3_ACCESS_KEY_ID": "k", "S3_SECRET_ACCESS_KEY": "s",
               "ECHO_METRICS_FILE": "m.json"}):
        got, want = tconfig.load_config(e), j_load_config(e)
        for field in ("hf_token", "s3_bucket", "s3_region", "s3_access_key",
                      "s3_secret_key", "s3_endpoint", "voices_dir",
                      "output_dir", "model_dir", "issues", "metrics_file",
                      "s3_configured"):
            assert getattr(got, field) == getattr(want, field), field


def test_config_device_defaults_to_the_card(env):
    assert tconfig.load_config({}).device == "cuda"
    assert tconfig.load_config(env).device == "cpu"


def test_scan_voices(env):
    d = env["AUDIO_VOICES_DIR"]
    for name in ("b.wav", "a.FLAC", "notes.txt", "c.opus"):
        open(os.path.join(d, name), "w").close()
    assert tconfig.scan_voices(d) == ["a.FLAC", "b.wav", "c.opus"]
    assert tconfig.scan_voices(os.path.join(d, "missing")) == []


def test_device_info_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = tconfig.device_info()
    assert info["platform"] == "cpu" and info["device_count"] == 0


def test_device_info_reports_the_cards(monkeypatch):
    """With a card: its name and, where nvidia-smi runs, its power limit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(tconfig.shutil, "which", lambda name: None)
    assert tconfig._power_limits() is None
    assert "power_limits" not in tconfig.device_info()
    monkeypatch.setattr(tconfig, "_power_limits", lambda: ["700.00 W"])
    info = tconfig.device_info()
    assert info["platform"] == "cuda" and info["device_count"] == 1
    assert info["devices"] == ["NVIDIA H100 80GB HBM3"]
    assert info["power_limits"] == ["700.00 W"]


# ---------------------------------------------------------------------------
# metrics (the cases of tests/test_metrics.py)
# ---------------------------------------------------------------------------

def test_counter_and_gauge():
    metrics.counter("c").inc()
    metrics.counter("c").inc(4)
    metrics.gauge("g").set(7.5)
    snap = metrics.snapshot()
    assert snap["c"] == 5 and snap["g"] == 7.5


def test_histogram_percentiles_and_lifetime():
    h = metrics.histogram("h", window=100)
    for v in range(1, 201):
        h.observe(float(v))
    s = h.snapshot()
    assert s["count"] == 200 and s["min"] == 1.0 and s["max"] == 200.0
    assert s["sum"] == sum(range(1, 201))
    assert 145 <= s["p50"] <= 155 and s["p99"] >= 195
    assert s["window"] == 100


def test_metric_type_conflict_raises():
    metrics.counter("x")
    with pytest.raises(TypeError):
        metrics.gauge("x")


def test_metrics_thread_safety_counts_exactly():
    c = metrics.counter("racy")
    h = metrics.histogram("racy_h", window=64)

    def work():
        for _ in range(500):
            c.inc()
            h.observe(1.0)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 4000 and h.snapshot()["count"] == 4000


def test_write_metrics_file_atomic(tmp_path):
    metrics.counter("jobs").inc(3)
    path = tmp_path / "metrics.json"
    metrics.write_metrics_file(str(path), extra={"batch_queue": {"d": 1}})
    payload = json.loads(path.read_text())
    assert payload["metrics"]["jobs"] == 3
    assert payload["batch_queue"] == {"d": 1} and "time" in payload
    assert not list(tmp_path.glob("*.tmp.*"))


def test_handler_counts_requests_errors_and_writes_file(env, tmp_path):
    mfile = tmp_path / "m.json"
    cfg = tconfig.load_config({**env, "ECHO_METRICS_FILE": str(mfile)})
    out = th.handler({"input": {}}, cfg=cfg)
    assert out["error_type"] == "ValueError"
    snap = metrics.snapshot()
    assert snap["requests_total"] == 1 and snap["errors_total"] == 1
    assert snap["errors_ValueError"] == 1
    assert json.loads(mfile.read_text())["metrics"]["errors_total"] == 1


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

def test_storage_writes_a_local_wav(cfg, monkeypatch):
    monkeypatch.setattr(audio_io, "ffmpeg_available", lambda: False)
    audio = (0.5 * np.sin(np.linspace(0, 100, 4410))[None]).astype(np.float32)
    out = storage.save_and_upload_audio(audio, 44100, cfg, "req1",
                                        session_id="s1")
    assert out["codec"] == "wav" and "url" not in out
    assert out["filename"].startswith("s1_req1_")
    back, sr = audio_io.read_wav(out["local_path"])
    assert sr == 44100 and back.shape == audio.shape
    np.testing.assert_allclose(back, audio, atol=1e-4)


def test_storage_uploads_through_an_s3_client(env, monkeypatch):
    cfg = tconfig.load_config({**env, "S3_BUCKET_NAME": "bkt",
                               "S3_ACCESS_KEY_ID": "k",
                               "S3_SECRET_ACCESS_KEY": "s"})
    assert cfg.s3_configured
    calls = {}

    class Client:
        def put_object(self, Bucket, Key, Body):
            calls["put"] = (Bucket, Key, len(Body))

        def generate_presigned_url(self, op, Params, ExpiresIn):
            calls["url"] = (op, Params, ExpiresIn)
            return f"https://example.invalid/{Params['Key']}"

    monkeypatch.setattr(audio_io, "ffmpeg_available", lambda: False)
    monkeypatch.setattr(storage, "_s3_client", lambda c: Client())
    out = storage.save_and_upload_audio(np.zeros((1, 100), np.float32),
                                        44100, cfg, "req2")
    key = f"audio/{out['filename']}"
    assert out["s3_key"] == key and out["url"].endswith(key)
    assert calls["put"][:2] == ("bkt", key) and calls["put"][2] > 44
    assert calls["url"][2] == storage.PRESIGNED_URL_TTL

    def broken(c):
        raise RuntimeError("no route")

    monkeypatch.setattr(storage, "_s3_client", broken)
    out = storage.save_and_upload_audio(np.zeros((1, 100), np.float32),
                                        44100, cfg, "req3")
    assert out["s3_error"] == "no route" and os.path.isfile(out["local_path"])


@pytest.mark.parametrize("what,bad", [
    ("session_id", "../../etc"), ("request_id", "a/b"),
    ("request_id", ".hidden"), ("session_id", "x" * 65)])
def test_storage_sanitizes_components(cfg, what, bad):
    kw = {"session_id": bad} if what == "session_id" else {}
    rid = bad if what == "request_id" else "req1"
    with pytest.raises(ValueError, match=f"invalid {what}"):
        storage.save_and_upload_audio(np.zeros((1, 10), np.float32), 44100,
                                      cfg, rid, **kw)
    assert storage.sanitize_component("ok-Name_1.2", "x") == "ok-Name_1.2"


# ---------------------------------------------------------------------------
# presets and buckets against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jpresets.load_presets()))
def test_every_preset_matches_jax(name):
    assert tpresets.get_preset(name) == jpresets.get_preset(name)


def test_preset_set_and_unknown_preset():
    assert tpresets.load_presets() == jpresets.load_presets()
    with pytest.raises(KeyError, match="unknown sampler preset"):
        tpresets.get_preset("nope")
    # a preset is a base that explicit parameters override
    _, p = th.build_sample_fn({"num_steps": 3},
                              preset="Independent-High-Speaker-CFG")
    assert p["num_steps"] == 3 and p["rescale_sigma"] == 3.0


def test_buckets_match_jax():
    for n in (0, 1, 100, 640, 641, 2816, 2817, 6400, 9000):
        assert tpresets.pick_speaker_bucket(n) == jpresets.pick_speaker_bucket(n)
        assert tpresets.pick_text_bucket(n) == jpresets.pick_text_bucket(n)
    for text in ("", "Hi.", "A longer sentence, a few seconds of speech.",
                 "x" * 300, "y" * 4000):
        for top in (640, 320, 160):
            assert (tpresets.pick_sequence_bucket(text, top)
                    == jpresets.pick_sequence_bucket(text, top))
    for name in ("TEXT_BUCKETS", "SPEAKER_BUCKETS", "SEQUENCE_BUCKETS",
                 "STREAM_CHUNK_SIZES", "MAX_STREAM_CHUNKS"):
        assert getattr(tpresets, name) == getattr(jpresets, name), name


# ---------------------------------------------------------------------------
# StageTimer, trace
# ---------------------------------------------------------------------------

def test_stage_timer_accumulates_and_reports():
    t = StageTimer()
    for name, secs in (("a", 0.01), ("a", 0.01), ("b", 0.005)):
        with t.stage(name):
            time.sleep(secs)
    rep = t.report()
    assert rep["a"]["calls"] == 2 and rep["b"]["calls"] == 1
    assert rep["a"]["seconds"] >= 0.02 and t.total() >= 0.025
    assert t.rtf(audio_seconds=1.0) > 0


def test_stage_timer_records_on_exception():
    t = StageTimer()
    with pytest.raises(RuntimeError):
        with t.stage("fails"):
            raise RuntimeError("boom")
    assert t.report()["fails"]["calls"] == 1
    assert StageTimer().rtf(10.0) == float("inf")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as path:
        torch.ones(64).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert events


# ---------------------------------------------------------------------------
# the handler against the JAX handler
# ---------------------------------------------------------------------------

def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _keys(d):
    """The nested key structure of an envelope."""
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_envelope_keys_match_jax(pair, env):
    """The same voiced two-chunk job through both handlers: the same
    envelope keys at every level, the same chunk count and metadata."""
    jm, port = pair
    shutil.copy(VOICE, os.path.join(env["AUDIO_VOICES_DIR"], "v.wav"))
    job = {"text": TWO_CHUNKS, "parameters": FAST, "seed": 7,
           "speaker_voice": "v.wav", "max_chars_per_chunk": 80,
           "session_id": "s1", "request_id": "r1"}
    want = jh.synthesize(dict(job), cfg=j_load_config(env), models=jm)
    got = th.synthesize(dict(job), cfg=tconfig.load_config(env), models=port)
    assert _keys(got) == _keys(want)
    for k in ("num_chunks", "seed", "sampler", "speaker_voice", "request_id",
              "sample_rate"):
        assert got["metadata"][k] == want["metadata"][k], k
    assert got["metadata"]["num_chunks"] == 2
    assert got["metadata"]["device"] == "cpu"
    audio, sr = audio_io.read_wav(got["local_path"])
    assert sr == 44100 and np.isfinite(audio).all() and audio.shape[1] > 0


BAD_JOBS = {
    "no_text": {},
    "text_not_str": {"text": 5},
    "too_long": {"text": "x" * 4001},
    "boundary_mode": {"text": "One sentence here. " * 10,
                      "max_chars_per_chunk": 60, "boundary_mode": "bogus"},
    "unknown_param": {"text": "hi", "parameters": {"nope": 1}},
    "unknown_preset": {"text": "hi", "preset": "nope"},
    "voice_traversal": {"text": "hi", "speaker_voice": "../../etc/passwd"},
    "voice_extension": {"text": "hi", "speaker_voice": "voice.txt"},
    "voice_missing": {"text": "hi", "speaker_voice": "missing.wav"},
    "session_id": {"text": "hi", "session_id": "../evil"},
    "request_id": {"text": "hi", "request_id": "/abs/path"},
    "stream_chunk_size": {"text": "x", "stream": True, "chunk_size": 7},
    "stream_num_chunks": {"text": "x", "stream": True, "num_chunks": 0},
    "stream_chunk_sizes": {"text": "x", "stream": True,
                           "chunk_sizes": [160, 7]},
    "stream_empty_sizes": {"text": "x", "stream": True, "chunk_sizes": []},
    "stream_session": {"text": "x", "stream": True, "session_id": "../e"},
}


@pytest.mark.parametrize("name", sorted(BAD_JOBS))
def test_error_envelopes_match_jax(pair, env, monkeypatch, name):
    """The same bad job through both handlers: the error envelope's keys
    and error type agree (the models are the tiny bundles)."""
    jm, port = pair
    monkeypatch.setattr(jh.models_mod, "load_models", lambda *a, **k: jm)
    monkeypatch.setattr(th.models_mod, "load_models", lambda *a, **k: port)
    job = {"input": dict(BAD_JOBS[name], parameters=BAD_JOBS[name].get(
        "parameters", FAST))}
    want = jh.handler(job, cfg=j_load_config(env))
    got = th.handler(job, cfg=tconfig.load_config(env))
    assert set(got) == set(want) == {"error", "error_type", "traceback"}
    assert got["error_type"] == want["error_type"]


def test_chunk_seeds_advance_by_the_stride(pair, cfg, monkeypatch):
    _, port = pair
    seeds = []
    real = th.sample_pipeline

    def spy(models, fn, chunk, spk, rng_seed, **kw):
        seeds.append(rng_seed)
        return real(models, fn, chunk, spk, rng_seed, **kw)

    monkeypatch.setattr(th, "sample_pipeline", spy)
    out = th.synthesize({"text": "One sentence here. " * 10,
                         "parameters": FAST, "seed": 7,
                         "max_chars_per_chunk": 60,
                         "boundary_mode": "crossfade"}, cfg=cfg, models=port)
    assert out["status"] == "success" and len(seeds) >= 2
    assert seeds == [7 + i * th.SEED_STRIDE for i in range(len(seeds))]


def test_voice_cache(pair, cfg, monkeypatch):
    """A repeated voice encodes once, and the cached latent gives the
    fresh encode's audio byte for byte; the entry is the JAX handler's
    (latent, mask, bucket); another bundle misses; the file's mtime and
    clear_models() invalidate."""
    jm, port = pair
    path = os.path.join(cfg.voices_dir, "c.wav")
    shutil.copy(VOICE, path)
    calls = []
    real = tpl.get_speaker_latent_and_mask
    monkeypatch.setattr(tpl, "get_speaker_latent_and_mask",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    job = {"text": "Cache test.", "parameters": FAST, "seed": 9,
           "speaker_voice": "c.wav"}
    out1 = th.synthesize(dict(job), cfg=cfg, models=port)
    out2 = th.synthesize(dict(job), cfg=cfg, models=port)
    assert len(calls) == 1
    lat, mask, bucket = th.get_voice_latent(port, path)
    jlat, jmask, jbucket = jh.get_voice_latent(jm, path)
    n = audio_io.load_audio(path).shape[-1] // DAC_CFG.frame_length
    assert bucket == jbucket == tpresets.pick_speaker_bucket(n)
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    np.testing.assert_allclose(lat, np.asarray(jlat), atol=2e-5, rtol=1e-4)
    assert mask.sum() == n
    wav = _read_bytes(out1["local_path"])
    assert _read_bytes(out2["local_path"]) == wav
    other = tpl.EchoModels(port.dit, port.dac, port.pca, port.dtype)
    th.get_voice_latent(other, path)
    assert len(calls) == 2
    th.get_voice_latent(port, path)
    assert len(calls) == 2
    tmodels.clear_models()
    out3 = th.synthesize(dict(job), cfg=cfg, models=port)
    assert len(calls) == 3
    assert _read_bytes(out3["local_path"]) == wav
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    th.get_voice_latent(port, path)
    assert len(calls) == 4


def test_metrics_action_and_health_check(pair, cfg, monkeypatch):
    _, port = pair
    from echo_tts_torch.serve.server import MicroBatchServer
    srv = MicroBatchServer(port, max_batch=2, max_wait_s=0.01)
    try:
        metrics.counter("requests_total").inc(2)
        out = th.handler({"input": {"action": "metrics"}}, cfg=cfg,
                         batch_server=srv)
        assert out["metrics"]["requests_total"] == 2
        assert out["batch_queue"]["max_batch"] == 2
        health = th.handler({"input": {"action": "health_check"}}, cfg=cfg,
                            batch_server=srv)
        assert health["status"] == "healthy" and not health["models_loaded"]
        assert health["batch_queue"]["queue_depth"] == 0
        assert health["dit_quant"] == "none"
        assert health["device"]["platform"] in ("cpu", "cuda")
        assert json.dumps(health)
    finally:
        srv.shutdown()
    # after a load through the serving cache
    monkeypatch.setattr(tmodels, "random_models", lambda *a, **k: port)
    th.synthesize({"text": "Loaded.", "parameters": FAST, "_allow_random": True},
                  cfg=cfg)
    health = th.health_check(cfg)
    assert health["models_loaded"] and health["dit_quant"] == "none"
    snap = metrics.snapshot()
    assert snap["rtf"]["count"] == 1
    assert snap["stage_synthesis_seconds"]["count"] == 1
    assert snap["stage_model_load_seconds"]["count"] == 1


def test_stream_job_events_match_jax(pair, env, monkeypatch):
    """A streaming job through both handlers: the same block events and
    final envelope keys; the blocks' WAVs concatenate to the final file."""
    jm, port = pair
    monkeypatch.setattr(jh, "STREAM_CHUNK_SIZES", (4,))
    monkeypatch.setattr(th, "STREAM_CHUNK_SIZES", (4,))
    job = {"text": "Streamed serving.", "stream": True, "num_chunks": 2,
           "chunk_size": 4, "parameters": {"num_steps": 2}, "seed": 1,
           "session_id": "sess1"}
    want_ev, got_ev = [], []
    want = jh.synthesize_stream(dict(job), cfg=j_load_config(env), models=jm,
                                on_block=want_ev.append)
    got = th.synthesize_stream(dict(job), cfg=tconfig.load_config(env),
                               models=port, on_block=got_ev.append)
    assert _keys(got) == _keys(want)
    assert [_keys(e) for e in got_ev] == [_keys(e) for e in want_ev]
    assert [(e["index"], e["latent_start"], e["latent_end"], e["is_last"])
            for e in got_ev] == [(0, 0, 4, False), (1, 4, 8, True)]
    parts = [audio_io.read_wav(e["local_path"])[0] for e in got_ev]
    full, _ = audio_io.read_wav(got["local_path"])
    np.testing.assert_allclose(np.concatenate(parts, -1), full, atol=1e-4)
    assert got["metadata"]["num_blocks"] == 2
    assert metrics.snapshot()["ttfa_seconds"]["count"] == 1


def test_stream_job_runs_the_w8a8_dit(pair, cfg, monkeypatch):
    """Under ECHO_DIT_QUANT=int8 a streaming job runs the W8A8 DiT (the
    blockwise sampler and the latent encoder take its Int8Linear leaves as
    they stand): the job's blocks equal stream_synthesize's on the W8A8
    bundle, and differ from the bf16 DiT's."""
    from echo_tts_torch.ops import int8_matmul
    from echo_tts_torch.serve.streaming import stream_synthesize
    _, port = pair
    monkeypatch.setenv("ECHO_DIT_QUANT", "int8")
    monkeypatch.setattr(tmodels, "random_models", lambda *a, **k: port)
    shutil.copy(VOICE, os.path.join(cfg.voices_dir, "v.wav"))
    calls = []
    real = int8_matmul.int8_matmul_plain
    monkeypatch.setattr(int8_matmul, "int8_matmul_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(th, "STREAM_CHUNK_SIZES", (4, 8))
    events = []
    out = th.handler({"input": {
        "text": "Quantized stream.", "stream": True, "chunk_size": 4,
        "chunk_sizes": [4, 8],
        "parameters": {"num_steps": 2}, "speaker_voice": "v.wav", "seed": 3,
        "_allow_random": True}}, cfg=cfg, on_block=events.append)
    assert out.get("status") == "success", out.get("traceback")
    assert tmodels.served_quant_mode() == "int8" and calls
    n_linears = 8 * DIT_CFG.num_layers
    assert len(calls) % n_linears == 0
    qm = tmodels.load_models(None, device="cpu", allow_random=True)
    lat, mask, _ = th.get_voice_latent(qm, os.path.join(cfg.voices_dir, "v.wav"))
    kw = dict(chunk_sizes=[4, 8], seed=3, sampler_params={"num_steps": 2},
              speaker_latent=lat, speaker_mask=mask)
    want = [c.audio for c in stream_synthesize(qm, "Quantized stream.", **kw)]
    for e, w in zip(events, want):
        np.testing.assert_allclose(audio_io.read_wav(e["local_path"])[0], w,
                                   atol=1e-4)
    plain = [c.audio for c in stream_synthesize(port, "Quantized stream.", **kw)]
    assert not np.allclose(np.concatenate(plain, -1), np.concatenate(want, -1),
                           atol=1e-6)


def test_handler_generator(pair, cfg, monkeypatch):
    _, port = pair
    monkeypatch.setattr(th, "STREAM_CHUNK_SIZES", (4,))
    monkeypatch.setattr(th, "load_config", lambda *a, **k: cfg)
    monkeypatch.setattr(th.models_mod, "load_models", lambda *a, **k: port)
    events = list(th.handler_generator(
        {"input": {"text": "Gen protocol.", "stream": True, "num_chunks": 2,
                   "chunk_size": 4, "parameters": {"num_steps": 2}}}))
    assert [e.get("event") for e in events] == ["block", "block", "final"]
    events = list(th.handler_generator({"input": {"stream": True, "text": ""}}))
    assert len(events) == 1 and events[0]["error_type"] == "ValueError"


def test_serve_stdin_concurrent(pair, cfg, monkeypatch):
    """JSON lines through the concurrent protocol: every job answered by
    request_id, a bad line answered with the JSONDecodeError envelope."""
    _, port = pair
    monkeypatch.setattr(th.models_mod, "load_models", lambda *a, **k: port)
    out = []
    lines = [json.dumps({"input": {"text": f"Line {i}.", "parameters": FAST,
                                   "seed": i, "request_id": f"r{i}"}})
             for i in range(3)] + ["{not json"]
    th.serve_stdin_concurrent(cfg, max_batch=4, lines=lines, emit=out.append)
    ok = sorted(o["metadata"]["request_id"] for o in out if "metadata" in o)
    assert ok == ["r0", "r1", "r2"]
    assert [o["error_type"] for o in out if "error" in o] == ["JSONDecodeError"]


def test_main_warmup_compile_and_serial_stdin(pair, env, monkeypatch,
                                              capsys):
    """`main --warmup-compile` answers one short request (there are no
    kernels to build on the CPU); `main` without runpod serves JSON lines
    on stdin, one envelope a line, a bad line answered with the
    JSONDecodeError envelope."""
    import io
    import sys
    _, port = pair
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(th.models_mod, "load_models", lambda *a, **k: port)
    monkeypatch.setattr(th, "SAMPLER_DEFAULTS", {**th.SAMPLER_DEFAULTS, **FAST})
    texts = []
    real = th.sample_pipeline
    monkeypatch.setattr(th, "sample_pipeline", lambda *a, **k: (
        texts.append(a[2]) or real(*a, **k)))
    th.main(["--warmup-compile", "--allow-random-weights"])
    assert texts == ["Warmup utterance."]
    monkeypatch.setitem(sys.modules, "runpod", None)   # not installed
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        json.dumps({"input": {"text": "Hi.", "parameters": FAST}})
        + "\n\n{not json\n"))
    capsys.readouterr()
    th.main(["--allow-random-weights"])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert out[0]["status"] == "success"
    assert out[1]["error_type"] == "JSONDecodeError" and len(out) == 2


# ---------------------------------------------------------------------------
# the serving codec's snake
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,device,want", [
    (None, "cpu", False), (None, "cuda", True), ("1", "cpu", True),
    ("true", "cpu", True), ("0", "cuda", False), ("no", "cuda", False)])
def test_snake_approx_follows_the_device_unless_set(monkeypatch, value,
                                                    device, want):
    if value is None:
        monkeypatch.delenv("ECHO_SNAKE_APPROX", raising=False)
    else:
        monkeypatch.setenv("ECHO_SNAKE_APPROX", value)
    assert tmodels._serving_dac_config(torch.device(device)).snake_approx is want


def test_load_models_serves_the_snake_it_is_asked_for(monkeypatch):
    """ECHO_SNAKE_APPROX=1 reaches the served codec on the CPU, where the
    default is exact sin; a later load with another setting raises."""
    seen = []

    def small(device, dtype, dac_cfg):
        seen.append(dac_cfg)
        return tpl.random_models(device, torch.float32, dit_cfg=DIT_CFG,
                                 dac_cfg=dataclasses.replace(
                                     DAC_CFG, snake_approx=dac_cfg.snake_approx))

    monkeypatch.setattr(tmodels, "random_models", small)
    monkeypatch.setenv("ECHO_SNAKE_APPROX", "1")
    m = tmodels.load_models(None, device="cpu", allow_random=True)
    assert seen[-1].snake_approx and m.dac_cfg.snake_approx
    assert tmodels.models_loaded()
    monkeypatch.setenv("ECHO_SNAKE_APPROX", "0")
    with pytest.raises(RuntimeError, match="clear_models"):
        tmodels.load_models(None, device="cpu", allow_random=True)
    tmodels.clear_models()
    assert not tmodels.models_loaded()
    assert not tmodels.load_models(None, device="cpu",
                                   allow_random=True).dac_cfg.snake_approx
