"""The port's runnable entry points (echo_tts_torch/examples/) on the CPU at
the tiny config: generate and streaming_demo write the WAV that
sample_pipeline and stream_synthesize give at the same seed, bit for bit;
the long-stream soak's tiny run reports ok over 8 blocks, and each of its
gates trips on a doctored table or reading; the few-step recipe's tiny
run writes its report and serves the student; none of them, nor the
measurement modules (bench_*.py, tested in test_torch_bench_examples.py),
imports JAX, and each of them, the headline bench (bench.py, tested in
test_torch_bench.py) too, refuses the CPU unless asked for it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from echo_tts_torch import bench
from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
from echo_tts_torch.examples import (
    bench_attention, bench_few_step, bench_incremental_crossover, bench_int8,
    bench_int8_surfaces, bench_kv_quant, bench_long_reference,
    bench_stream_int8, bench_train_step, bench_ttfa_breakdown,
    distill_few_step, generate, soak_long_stream, streaming_demo)
from echo_tts_torch.pipeline import audio_io
from echo_tts_torch.pipeline.pipeline import random_models, sample_pipeline
from echo_tts_torch.serve import models as serve_models
from echo_tts_torch.serve.handler import build_sample_fn
from echo_tts_torch.serve.presets import growing_schedule
from echo_tts_torch.serve.streaming import stream_synthesize
from echo_tts_torch.tools.checkpoint import is_bundle

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOICE = os.path.join(REPO, "tests", "data", "voice.wav")
TEXT = "Entry points speak the same words."


@pytest.fixture(scope="module")
def models():
    return random_models("cpu", torch.float32, dit_cfg=tiny_dit_config(),
                         dac_cfg=tiny_dac_config())


def _wav_bytes(path, audio, rate):
    audio_io.write_wav(path, audio, rate)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("voice", [False, True], ids=["no_voice", "voice"])
def test_generate_writes_sample_pipelines_audio(models, tmp_path, voice):
    out = str(tmp_path / "out.wav")
    argv = ["--text", TEXT, "--seed", "3", "--steps", "4", "--preset",
            "Independent-High-CFG", "--out", out]
    if voice:
        argv += ["--voice", VOICE]
    assert generate.main(argv, models=models) == 0
    sample_fn, p = build_sample_fn({"num_steps": 4},
                                   preset="Independent-High-CFG")
    assert p["num_steps"] == 4
    speaker = audio_io.load_audio(VOICE) if voice else None
    want, _ = sample_pipeline(models, sample_fn, TEXT, speaker, rng_seed=3)
    rate = models.dac_cfg.sample_rate
    with open(out, "rb") as f:
        assert f.read() == _wav_bytes(str(tmp_path / "want.wav"), want, rate)
    got, sr = audio_io.read_wav(out)
    assert sr == rate and got.shape == want.shape and np.isfinite(want).all()


@pytest.mark.parametrize("argv,sizes", [
    (["--total-latents", "120"], growing_schedule(120)),
    (["--chunk-size", "8", "--num-chunks", "3"], [8, 8, 8]),
], ids=["growing", "uniform"])
def test_streaming_demo_writes_the_streams_audio(models, tmp_path, argv,
                                                 sizes):
    out = str(tmp_path / "stream.wav")
    assert streaming_demo.main(["--text", TEXT, "--voice", VOICE, "--seed",
                                "5", "--out", out] + argv, models=models) == 0
    chunks = list(stream_synthesize(models, TEXT, audio_io.load_audio(VOICE),
                                    chunk_sizes=sizes, seed=5))
    want = np.concatenate([c.audio for c in chunks], axis=-1)
    assert want.shape[-1] == sum(sizes) * models.dac_cfg.frame_length
    with open(out, "rb") as f:
        assert f.read() == _wav_bytes(str(tmp_path / "want.wav"), want,
                                      models.dac_cfg.sample_rate)


def test_soak_tiny_reports_ok(tmp_path):
    path = str(tmp_path / "soak.json")
    assert soak_long_stream.main(["--tiny", "--blocks", "8", "--device",
                                  "cpu", "--report", path]) == 0
    with open(path) as f:
        report = json.load(f)
    assert report["ok"], report["failures"]
    assert len(report["blocks"]) == 8 and report["total_latents"] == 64
    assert [b["block"] for b in report["blocks"]] == list(range(8))
    assert report["audio_samples"] == 64 * tiny_dac_config().frame_length
    assert "tail_over_mid_ratio" in report and report["card"] == "cpu"
    # no device memory on the CPU: the memory gate is skipped
    assert "memory_growth_mb" not in report
    assert report["memory_baseline_mb"] is None
    assert report["warm_blocks"] == soak_long_stream.WARM_BLOCKS


def _flat_table(n=8, ms=100.0):
    return [{"block": i, "latents": 320, "block_ms": ms,
             "elapsed_s": (i + 1) * ms / 1e3, "memory_mb": 1000.0}
            for i in range(n)]


@pytest.mark.parametrize("case", ["flat", "latency", "memory", "length",
                                  "finite"])
def test_soak_gates_trip_on_a_doctored_run(case):
    """Each gate alone: the tail blocks at twice the middle's time (tail/mid
    2.0), 300 MB of memory growth, one sample short, a NaN."""
    table = _flat_table()
    n = 8 * 320 * 2048
    audio = np.zeros((1, n), np.float32)
    base, after = 1 << 30, (1 << 30) + 100 * 2**20
    if case == "latency":
        for b in table[-4:]:
            b["block_ms"] = 200.0
    elif case == "memory":
        after = base + 300 * 2**20
    elif case == "length":
        audio = audio[:, 1:]
    elif case == "finite":
        audio[0, 7] = np.nan
    numbers, failures = soak_long_stream.gates(table, audio, n, base, after)
    if case == "flat":
        assert failures == []
        assert numbers == {"tail_over_mid_ratio": 1.0,
                           "memory_growth_mb": 100.0}
        return
    assert len(failures) == 1, failures
    if case == "latency":
        assert numbers["tail_over_mid_ratio"] == 2.0
        assert "tail/mid = 2.000" in failures[0]
    elif case == "memory":
        assert numbers["memory_growth_mb"] == 300.0
        assert "grew 300.0 MB" in failures[0]
    elif case == "length":
        assert f"audio length {n - 1} != {n}" in failures[0]
    else:
        assert "non-finite" in failures[0]


def test_soak_latency_gate_needs_eight_blocks():
    numbers, failures = soak_long_stream.gates(
        _flat_table(4), np.zeros((1, 5), np.float32), 5, None, None)
    assert numbers == {} and failures == []


@pytest.mark.parametrize("given", [False, True], ids=["built", "injected"])
def test_distill_few_step_tiny_writes_report_and_serves(models, tmp_path,
                                                        given):
    """The tiny teacher built from --device cpu, or passed in as models
    (then no --device: the given models' device is used)."""
    out = str(tmp_path / "distilled")
    argv = ["--tiny", "--steps", "1", "--student-steps", "2", "--substeps",
            "1", "--batch-size", "2", "--out", out]
    kw = {"models": models} if given else {}
    assert distill_few_step.main(argv + ([] if given else ["--device", "cpu"]),
                                 **kw) == 0
    with open(os.path.join(out, "distill_report.json")) as f:
        report = json.load(f)
    assert report["num_steps"] == 1 and report["num_student_steps"] == 2
    assert report["quant_aware"] and np.isfinite(report["loss_last"])
    assert [s for s, _ in report["eval_mse_curve"]] == [0, 1]
    assert report["serve_smoke"]["ok"]
    assert is_bundle(report["checkpoint"])
    assert not serve_models.models_loaded()


def test_iter_corpus_reads_transcripts(tmp_path):
    rate = 44100
    tone = np.sin(np.arange(4410) / 7.0).astype(np.float32)[None] * 0.5
    audio_io.write_wav(str(tmp_path / "b_second_take.wav"), tone, rate)
    audio_io.write_wav(str(tmp_path / "a.wav"), tone, rate)
    (tmp_path / "a.txt").write_text("  The first transcript.\n")
    (tmp_path / "notes.txt").write_text("not audio")
    got = list(distill_few_step.iter_corpus(str(tmp_path)))
    assert [t for _, t in got] == ["The first transcript.", "b second take"]
    assert all(a.shape == (1, 4410) for a, _ in got)


def test_synthetic_corpus(models):
    got = list(distill_few_step.synthetic_corpus(models, n=5, seed=1))
    spl = models.dac_cfg.frame_length
    assert len(got) == 5 and got[4][1] == got[0][1]
    for audio, _ in got:
        assert audio.shape[1] % spl == 0 and 24 <= audio.shape[1] // spl < 40


BENCH_MODULES = [bench_kv_quant, bench_int8_surfaces, bench_train_step,
                 bench_long_reference, bench_few_step, bench_stream_int8,
                 bench_ttfa_breakdown, bench_incremental_crossover,
                 bench_attention, bench_int8]


@pytest.mark.parametrize("module,argv", [
    (generate, ["--random-weights"]),
    (streaming_demo, ["--random-weights"]),
    (soak_long_stream, []),
    (soak_long_stream, ["--tiny"]),
    (distill_few_step, []),
    (distill_few_step, ["--tiny"]),
] + [(m, []) for m in BENCH_MODULES] + [(bench_kv_quant, ["--tiny"]),
                                          (bench, [])],
    ids=["generate", "streaming_demo", "soak", "soak_tiny", "distill",
         "distill_tiny"] + [m.__name__.rsplit(".", 1)[-1]
                            for m in BENCH_MODULES] + ["bench_tiny", "bench"])
def test_entry_points_refuse_the_cpu_by_default(module, argv, monkeypatch):
    """Without --device or ECHO_DEVICE they load on the card, --tiny too,
    and raise on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("ECHO_DEVICE", raising=False)
    serve_models.clear_models()
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(argv)


def test_entry_points_import_no_jax():
    code = ("import sys\n"
            "import echo_tts_torch.examples.generate\n"
            "import echo_tts_torch.examples.streaming_demo\n"
            "import echo_tts_torch.examples.distill_few_step\n"
            "import echo_tts_torch.examples.soak_long_stream\n"
            "import echo_tts_torch.tools.check_fullsize\n"
            + "".join(f"import {m.__name__}\n" for m in BENCH_MODULES) +
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] == 'echo_tts_tpu']\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr
