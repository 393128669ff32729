"""The port's measurement modules (echo_tts_torch/examples/bench_*.py) on
the CPU at the tiny config: each main prints one JSON line with the JAX
script's keys; what each computes besides its timings is held against the
JAX package or the JAX script on the same inputs: bench_kv_quant's int8
static K/V sampler (fp32, injected noise, the sampler tolerance 1e-4 /
1e-3), bench_int8's W8A8 error against fp32 (1e-5), bench_train_step's
FLOP count (exact), bench_few_step's step plan (exact) and
bench_long_reference's encode chunks and static columns per bucket
(exact); bench_train_step's sweep records an out-of-memory point and goes
on, and lets any other error through.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.config import tiny_dac_config as j_tiny_dac_config
from echo_tts_tpu.config import tiny_dit_config as j_tiny_dit_config
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.ops import quant as jq
from echo_tts_tpu.pipeline import pipeline as jpl
from echo_tts_tpu.sampler import euler as jeuler
from echo_tts_tpu.train.distill import (
    few_step_sampler_params as j_few_step_sampler_params)

from echo_tts_torch.config import (base_dit_config, tiny_dac_config,
                                   tiny_dit_config)
from echo_tts_torch.examples import (
    bench_attention, bench_few_step, bench_incremental_crossover, bench_int8,
    bench_int8_surfaces, bench_kv_quant, bench_long_reference,
    bench_stream_int8, bench_train_step, bench_ttfa_breakdown, stages)
from echo_tts_torch.pipeline.pipeline import random_models
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ARGS = ["--tiny", "--device", "cpu", "--warmup", "0", "--reps", "1"]

# each module, its argv, and the keys of its JSON line (the JAX script's)
MODULES = {
    "bench_kv_quant": (bench_kv_quant, ["--w4a8"], {"summary"}),
    "bench_int8_surfaces": (bench_int8_surfaces, [], {
        "metric", "value", "unit", "p50_short_int8_ms", "p50_short_rtf_int8",
        "throughput_rtf_b8_chip_int8", "note"}),
    "bench_train_step": (bench_train_step, ["--sweep", "--remats", "attn",
                                            "--b-max", "4"], {"sweep"}),
    "bench_long_reference": (bench_long_reference, [],
                             {"metric", "buckets"}),
    "bench_few_step": (bench_few_step, [], {
        "metric", "value", "unit", "prefill_ms", "sampler_few8_ms",
        "sampler_few8_int8_ms", "sampler_cfg40_ms", "decode_ms",
        "rtf_parity_40step", "rtf_few8_int8", "note"}),
    "bench_stream_int8": (bench_stream_int8, [], {
        "metric", "value", "unit", "ttfa_bf16_ms", "streamed_rtf_bf16",
        "ttfa_int8_ms", "streamed_rtf_int8", "note"}),
    "bench_ttfa_breakdown": (bench_ttfa_breakdown, [], {
        "host_text_ms", "prefill_ms", "sampler40_ms", "decode40_ms",
        "transfer_ms", "wav_write_ms", "components_sum_ms", "ttfa_stream_ms",
        "residual_ms", "fused_first_ms", "fused_vs_split_ms"}),
    "bench_incremental_crossover": (bench_incremental_crossover, ["320"],
                                    {"metric", "totals"}),
    "bench_attention": (bench_attention, [], {"metric", "rows"}),
    "bench_int8": (bench_int8, [], {"metric", "mlp", "proj",
                                    "w8a8_rel_err_vs_f32"}),
}
KV_ROW_KEYS = {"batch", "speaker_latents", "kv_mb_bf16", "kv_mb_int8",
               "sampler_ms_bf16_kv", "sampler_ms_int8_kv", "speedup",
               "hbm_in_use_mb"}
W4A8_KEYS = {"shape", "scan_ms_bf16", "scan_ms_w8a8", "scan_ms_w4a8_packed"}
TRAIN_ROW_KEYS = {"remat", "attn", "batch", "step_ms", "tokens_per_s",
                  "useful_tflops_rate", "mfu_vs_bf16_peak"}
BUCKET_KEYS = {"voice_encode_ms", "prefill_ms", "sampler_ms", "rtf_640seq"}
CROSSOVER_KEYS = {"schedule_blocks", "bucket", "audio_s", "reencode_s",
                  "reencode_rtf", "incremental_s", "incremental_rtf",
                  "incremental_wins"}


@pytest.fixture(scope="module")
def models():
    return random_models("cpu", torch.float32, dit_cfg=tiny_dit_config(),
                         dac_cfg=tiny_dac_config())


@pytest.fixture(scope="module")
def run(models):
    """name -> the stdout lines of that module's main on the tiny models
    (run once)."""
    out = {}

    def go(name):
        if name not in out:
            module, argv, _ = MODULES[name]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert module.main(argv + TINY_ARGS, models=models) == 0
            out[name] = buf.getvalue().strip().splitlines()
        return out[name]
    return go


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_prints_one_json_line_with_the_jax_keys(run, name):
    lines = run(name)
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert MODULES[name][2] <= set(line) and line["card"] == "cpu"
    if name == "bench_kv_quant":
        rows = line["summary"]
        assert [r.get("batch") for r in rows] == [1, 8, None]
        assert all(KV_ROW_KEYS <= set(r) and r["latents_finite"]
                   for r in rows[:2])
        assert rows[1]["speaker_latents"] == stages.TINY.speaker
        assert W4A8_KEYS <= set(rows[2])
    if name == "bench_train_step":
        assert [r["batch"] for r in line["sweep"]] == [2, 4]
        assert all(TRAIN_ROW_KEYS <= set(r) for r in line["sweep"])
        assert line["sweep"][-1]["hbm_max_for_policy"]
    if name == "bench_long_reference":
        assert line["metric"] == "long_reference_buckets"
        assert all(BUCKET_KEYS <= set(r) for r in line["buckets"].values())
    if name == "bench_incremental_crossover":
        assert CROSSOVER_KEYS <= set(line["totals"]["320"])


def _init_jax_dit(key):
    return jdit.init_dit_params(key, j_tiny_dit_config(), dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_pair():
    """A tiny fp32 DiT of the JAX package (initialised in one jitted
    program) and the port's copy of it."""
    cfg = tiny_dit_config()
    params = jax.jit(_init_jax_dit)(jax.random.PRNGKey(0))
    model = bridge.load_dit_state(
        bridge.dit_state_from_jax(jax.tree.map(np.asarray, params), cfg), cfg,
        device="cpu", dtype=torch.float32)
    return params, model


def test_kv_quant_int8_sampler_matches_jax(jax_pair):
    """bench_kv_quant's int8 static K/V (stages.prefill with kv_quant, the
    serving sampler's prefill) and step loop against the JAX
    package's quantize_kv_int8 + run_step_segments, same noise, fp32."""
    params, model = jax_pair
    cfg_j = j_tiny_dit_config()
    rng = np.random.default_rng(4)
    b, seq, n_text, n_spk, steps = 2, 12, 11, 8, 4
    ids = rng.integers(0, 256, (b, n_text)).astype(np.int32)
    tmask = np.ones((b, n_text), bool)
    tmask[:, 9:] = False
    spk = rng.standard_normal((b, n_spk, 80)).astype(np.float32)
    smask = np.ones((b, n_spk), bool)
    smask[1, 4:] = False
    noise = rng.standard_normal((b, seq, 80)).astype(np.float32)

    plan = jeuler.build_step_plan(steps, 0.5, 1.0, None, None, None, None)

    @jax.jit
    def reference(params, ids, tmask, spk, smask, noise):
        kv_t = jdit.get_kv_cache_text(params, cfg_j, ids, tmask)
        kv_s = jdit.get_kv_cache_speaker(params, cfg_j, spk)
        kv, cols = jdit.concat_static_kv(cfg_j, kv_t, kv_s)
        mask_cfg, mask_plain = jeuler.make_cfg_branch_masks(cfg_j, tmask,
                                                            smask)
        return jeuler.run_step_segments(
            params, cfg_j, noise, plan, jq.quantize_kv_int8(*kv), cols,
            mask_cfg, mask_plain, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
            speaker_kv_max_layers=None, dtype=jnp.float32)

    want = reference(params, *(jnp.asarray(a) for a in (ids, tmask, spk,
                                                         smask, noise)))

    inputs = {k: torch.from_numpy(v) for k, v in dict(
        text_ids=ids, text_mask=tmask, speaker_latent=spk,
        speaker_mask=smask, noise=noise).items()}
    pre = stages.prefill(model, inputs, torch.float32, kv_quant=True)
    assert set(pre.kv_static) == {"k8", "ks", "v8", "vs"}
    got = stages.sampler(model, stages.step_plan(steps), pre, inputs,
                         torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)


def test_int8_error_matches_jax():
    """bench_int8's W8A8 error against fp32, the JAX script's on the same
    operands (the JAX weight is (K, N), the port's (N, K))."""
    rng = np.random.default_rng(5)
    m, k, n = 48, 128, 96
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q = jq.quantize_weight_int8(jnp.asarray(w))
    ref = jnp.asarray(x) @ jnp.asarray(w)
    got = jq.int8_dot(jnp.asarray(x), q["q8"], q["s"], out_dtype=jnp.float32)
    want = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))
    rel, rel_bf16 = bench_int8.w8a8_error(torch.from_numpy(x),
                                          torch.from_numpy(w.T.copy()))
    assert abs(rel - want) <= 1e-5
    assert 0 < rel_bf16 < rel


def test_train_step_flop_count_is_the_jax_scripts():
    """The JAX script sets jax.config on import, so it runs in a process of
    its own."""
    code = ("import json, runpy\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "g = runpy.run_path('examples/bench_train_step.py', "
            "run_name='bench')\n"
            "from echo_tts_tpu.config import base_dit_config\n"
            "print(json.dumps([g['_useful_fwd_tflop'](base_dit_config(), b) "
            "for b in (1, 2, 8)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu",
                              "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = [bench_train_step.useful_fwd_tflop(base_dit_config(), b)
           for b in (1, 2, 8)]
    assert got == want


def test_few_step_plan_is_the_jax_plan():
    fs, plan = bench_few_step.few_step_plan()
    want_fs = j_few_step_sampler_params(8)
    assert fs == want_fs
    want = jeuler.build_step_plan(want_fs["num_steps"], want_fs["cfg_min_t"],
                                  want_fs["cfg_max_t"], None, None, None, None)
    for got_field, want_field in zip(plan, want):
        np.testing.assert_array_equal(got_field, np.asarray(want_field))
    assert not plan.has_cfg.any()


def test_long_reference_counts_are_jaxs(run, monkeypatch):
    """Per bucket: the chunks JAX's get_speaker_latent_and_mask encodes (its
    ae_encode counted, returning zeros), the latents it returns, and the
    static columns JAX's prefill gives them (by shape)."""
    line = json.loads(run("bench_long_reference")[0])
    cfg_j = j_tiny_dit_config()
    # the codec's samples per latent is all get_speaker_latent_and_mask
    # reads of the models once ae_encode is replaced
    j_models = jpl.EchoModels(None, cfg_j, None, j_tiny_dac_config(), None,
                              dtype=jnp.float32)
    spl = j_models.dac_cfg.frame_length
    params = jax.eval_shape(_init_jax_dit, jax.random.PRNGKey(0))
    calls = []

    def encode(models, audio):
        calls.append(audio.shape)
        return jnp.zeros((1, audio.shape[1] // spl, 80), jnp.float32)

    monkeypatch.setattr(jpl, "ae_encode", encode)
    text = stages.TINY.text

    def columns(n):
        def prefill(params, spk):
            kv_t = jdit.get_kv_cache_text(
                params, cfg_j, jnp.zeros((1, text), jnp.int32),
                jnp.ones((1, text), bool))
            kv_s = jdit.get_kv_cache_speaker(params, cfg_j, spk)
            return jdit.concat_static_kv(cfg_j, kv_t, kv_s)[1]
        return jax.eval_shape(prefill, params,
                              jax.ShapeDtypeStruct((1, n, 80),
                                                   jnp.float32)).shape[0]

    for bucket in bench_long_reference.buckets():
        calls.clear()
        lat, mask = jpl.get_speaker_latent_and_mask(
            j_models, np.zeros((1, bucket * spl), np.float32),
            max_speaker_latent_length=bucket, pad_to_max=True)
        row = line["buckets"][str(bucket)]
        assert row["encode_chunks"] == len(calls)
        assert row["speaker_latents"] == lat.shape[1]
        assert row["speaker_valid"] == int(mask.sum()) == bucket
        assert row["static_columns"] == columns(lat.shape[1])


def test_train_sweep_records_out_of_memory_and_goes_on(models, monkeypatch):
    model = bench_train_step.dit.trainable_copy(models.dit)
    real = bench_train_step.grad_step
    seen = []

    def step(model, batch, generator, remat):
        b = batch["latents"].shape[0]
        seen.append((remat, b))
        if b >= 4:
            raise torch.cuda.OutOfMemoryError("out of memory (stub)")
        return real(model, batch, generator, remat)

    monkeypatch.setattr(bench_train_step, "grad_step", step)
    args = argparse.Namespace(warmup=0, reps=1)
    lengths = (bench_train_step.TINY_SEQ, bench_train_step.TINY_TEXT_LEN,
               bench_train_step.TINY_SPK_LEN)
    rows = bench_train_step.sweep(model, ["kernel"], ["attn", "none"], 2, 16,
                                  lengths, args)
    assert seen == [("attn", 2), ("attn", 4), ("none", 2), ("none", 4)]
    assert [(r["remat"], r["batch"], r.get("oom", False)) for r in rows] == [
        ("attn", 2, False), ("attn", 4, True), ("none", 2, False),
        ("none", 4, True)]
    assert [r["step_ms"] is None for r in rows] == [False, True, False, True]
    assert [r.get("hbm_max_for_policy", False) for r in rows] == [
        True, False, True, False]

    def broken(model, batch, generator, remat):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(bench_train_step, "grad_step", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        bench_train_step.sweep(model, ["kernel"], ["attn"], 2, 16, lengths,
                               args)


@pytest.mark.parametrize("argv,steps", [([], 2), (["--steps", "1"], 1)])
def test_steps_option(models, argv, steps):
    """--steps, where a module takes it, sets the sampler calls' Euler steps
    (lengths.steps; default the config's: 2 at --tiny, 40 at full size),
    refuses fewer than one, and is refused where a module does not take it;
    a module runs with it and prints its line."""
    ap = stages.parser("doc", steps=True)
    _, _, lengths = stages.setup(ap, TINY_ARGS + argv, models)
    assert lengths.steps == steps
    with pytest.raises(SystemExit):
        stages.setup(stages.parser("doc", steps=True),
                     TINY_ARGS + ["--steps", "0"], models)
    with pytest.raises(SystemExit):
        stages.setup(stages.parser("doc"), TINY_ARGS + ["--steps", "1"],
                     models)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench_long_reference.main(TINY_ARGS + argv, models=models) == 0
    assert set(json.loads(buf.getvalue().strip().splitlines()[-1])) >= {
        "metric", "buckets"}
