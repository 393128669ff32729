"""The port's headline bench (echo_tts_torch/bench.py) on the CPU at the
tiny config in fp32: its JSON line has bench.py's keys (read from
bench.py's source with ast: importing bench.py sets JAX's compilation
cache), its constants are bench.py's, and what it times computes what
bench.py's programs compute, against the JAX package on the same bridged
weights and injected noise: the one-shot request and the stage chain
(prefill, sampler, decode) within the sampler's bound 1e-4 / 1e-3
(tests/test_torch_sampler.py), the stage chain against the bench's own
one-shot within 1e-6, the W8A8 sampler within the same bound on inputs
where no int8 rounding flips (tests/test_torch_sampler.py says why), and
each row of the B = 8 device stages' latents against the B = 1 chain on
its noise within 1e-5.
"""
import ast
import contextlib
import io
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.config import tiny_dit_config as j_tiny_dit_config
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.models.dac import dac as jdac
from echo_tts_tpu.ops import quant as jq
from echo_tts_tpu.sampler import euler as jeuler

from echo_tts_torch import bench
from echo_tts_torch.config import base_dac_config, tiny_dac_config, tiny_dit_config
from echo_tts_torch.examples import stages
from echo_tts_torch.ops.quant import dit_is_quantized, quantize_dit
from echo_tts_torch.pipeline import pipeline as tpl
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-3)
DIT_CFG, DAC_CFG = tiny_dit_config(), tiny_dac_config()
CFG_J = j_tiny_dit_config()
STEPS, SEQ = 4, 8
TINY_ARGS = ["--tiny", "--device", "cpu", "--reps", "1", "--warmup", "0"]


def _bench_py() -> ast.Module:
    with open(os.path.join(REPO, "bench.py")) as f:
        return ast.parse(f.read())


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _eval(node: ast.expr, names=None):
    """A constant expression of bench.py's source, evaluated."""
    return eval(compile(ast.Expression(node), "bench.py", "eval"),
                {"__builtins__": {"dict": dict, "range": range}},
                dict(names or {}))


def _globals(tree: ast.Module) -> dict:
    out = {}
    for n in tree.body:
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)):
            try:
                out[n.targets[0].id] = _eval(n.value, out)
            except (NameError, AttributeError, TypeError):
                pass
    return out


@pytest.fixture(scope="module")
def tiny_run(monkeypatch_module):
    """main's stdout and stderr at the tiny config, and the DiT it handed to
    quantize_dit (run once)."""
    seen = []
    monkeypatch_module.setattr(
        bench, "quantize_dit", lambda m: seen.append(m) or quantize_dit(m))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(TINY_ARGS)
    return rc, out.getvalue().strip().splitlines(), seen


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_line_keys_are_bench_pys(tiny_run):
    """(a) The printed keys are those of bench.py's final json.dumps dict,
    plus card and ranges."""
    call = next(n for n in ast.walk(_function(_bench_py(), "main"))
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "dumps")
    want = {k.value for k in call.args[0].keys}
    assert len(want) == 15
    rc, lines, _ = tiny_run
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == want | {"card", "ranges"}
    assert line["card"] == "cpu"
    assert set(line["ranges"]) <= want


def test_constants_are_bench_pys():
    """(b) Lengths, steps, guidance, the baseline, the stream's blocks and
    text, the batch's texts, the audio seconds and the sample counts."""
    tree = _bench_py()
    g = _globals(tree)
    full = stages.FULL
    assert (g["SEQ"], g["TEXT_LEN"], g["SPK_LEN"], g["NUM_STEPS"]) == (
        full.seq, full.text, full.speaker, full.steps)
    assert g["SHORT_SEQ"] == bench.SHORT_SEQ
    assert g["BASELINE_RTF"] == bench.BASELINE_RTF
    assert tuple(g["STREAM_BLOCKS"]) == stages.STREAM_BLOCKS
    assert g["STREAM_TEXT"] == stages.STREAM_TEXT
    assert g["BATCH_TEXTS"] == stages.BATCH_TEXTS
    dac = base_dac_config()
    assert g["AUDIO_SECONDS"] == full.seq * dac.frame_length / dac.sample_rate
    build = _function(tree, "build")
    assigns = {n.targets[0].id: n.value for n in ast.walk(build)
               if isinstance(n, ast.Assign) and len(n.targets) == 1
               and isinstance(n.targets[0], ast.Name)}
    assert _eval(assigns["sampler_kw"], g) == bench.sampler_kw(full.steps)
    # text_mask = jnp.arange(TEXT_LEN)[None, :] < 200
    assert _eval(assigns["text_mask"].comparators[0]) == full.text_valid
    # the sample counts: _timeit's default, main's n=5 for the short
    # request, and the stream's, the served stream's, the batch's and the
    # device stages' counts
    timeit_n = _eval(_function(tree, "_timeit").args.defaults[0])
    assert [bench.REPS[k] for k in ("prefill", "sampler", "decode",
                                    "sampler_int8")] == [timeit_n] * 4
    main = _function(tree, "main")
    # _timeit(lambda: full(SEQ), n=3), then _timeit(lambda: full(SHORT_SEQ), n=5)
    given_n = [_eval(k.value) for n in ast.walk(main) if isinstance(n, ast.Call)
               and getattr(n.func, "id", None) == "_timeit"
               for k in n.keywords if k.arg == "n"]
    assert given_n == [bench.REPS["value"], bench.REPS["p50_short"]]
    assert _eval(_function(tree, "_serve_ttfa").args.defaults[0]) == \
        bench.REPS["serve"]
    assert _eval(_function(tree, "_b8_chip").args.defaults[0]) == \
        bench.REPS["b8_chip"]

    def comprehension_count(callee):
        return [_eval(n.generators[0].iter) for n in ast.walk(main)
                if isinstance(n, ast.ListComp)
                and any(getattr(c.func, "id", None) == callee
                        for c in ast.walk(n.elt) if isinstance(c, ast.Call))]

    assert [len(r) for r in comprehension_count("_stream_once")] == [
        bench.REPS["stream"]]
    assert [len(r) for r in comprehension_count("_batch_once")] == [
        bench.REPS["batch"]]


@pytest.fixture(scope="module")
def pair(tiny_models):
    """The JAX package's tiny fp32 models and the port's copy of them."""
    port = tpl.EchoModels(
        dit=bridge.load_dit_state(bridge.dit_state_from_jax(
            jax.tree.map(np.asarray, tiny_models.dit_params), DIT_CFG),
            DIT_CFG, device="cpu", dtype=torch.float32),
        dac=bridge.load_dac_state(bridge.dac_state_from_jax(
            jax.tree.map(np.asarray, tiny_models.dac_params), DAC_CFG),
            DAC_CFG, device="cpu"),
        pca=bridge.pca_state(jax.tree.map(np.asarray, tiny_models.pca),
                             device="cpu"),
        dtype=torch.float32)
    return tiny_models, port


def _inputs(seed: int) -> dict:
    """A tiny request (stages.TINY's text and speaker lengths) and SEQ
    latents of noise, made with numpy."""
    rng = np.random.default_rng(seed)
    tiny = stages.TINY
    return dict(
        text_ids=rng.integers(0, 256, (1, tiny.text)).astype(np.int32),
        text_mask=np.arange(tiny.text)[None] < tiny.text_valid,
        speaker_latent=rng.standard_normal((1, tiny.speaker, 80)).astype(
            np.float32),
        speaker_mask=np.ones((1, tiny.speaker), bool),
        noise=rng.standard_normal((1, SEQ, 80)).astype(np.float32))


def _torch(inputs: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _j_decode(jm, latents):
    return jax.jit(lambda p, pca, x: jdac.decode_zq(
        p, jm.dac_cfg, jdac.pca_unwhiten(x, pca))[..., 0])(
            jm.dac_params, jm.pca, latents)


def _j_chain(params, inputs: dict):
    """bench.py's prefill and sampler_only programs, in fp32."""
    plan = jeuler.build_step_plan(STEPS, 0.5, 1.0, None, None, None, None)

    @jax.jit
    def chain(params, dit_params, ids, tmask, spk, smask, noise):
        kv_t = jdit.get_kv_cache_text(dit_params, CFG_J, ids, tmask)
        kv_s = jdit.get_kv_cache_speaker(dit_params, CFG_J, spk)
        kv, cols = jdit.concat_static_kv(CFG_J, kv_t, kv_s)
        mask_cfg, mask_plain = jeuler.make_cfg_branch_masks(CFG_J, tmask,
                                                            smask)
        return jeuler.run_step_segments(
            params, CFG_J, noise, plan, kv, cols, mask_cfg, mask_plain,
            cfg_scale_text=3.0, cfg_scale_speaker=8.0,
            speaker_kv_max_layers=None, dtype=jnp.float32)

    return chain(params[0], params[1], *(jnp.asarray(inputs[k]) for k in (
        "text_ids", "text_mask", "speaker_latent", "speaker_mask", "noise")))


def test_one_shot_matches_jax(pair):
    """(c) generate with injected noise against JAX's
    sample_euler_cfg_independent_guidances, pca_unwhiten, decode_zq."""
    jm, port = pair
    inputs = _inputs(0)
    want = jeuler.sample_euler_cfg_independent_guidances(
        jm.dit_params, CFG_J, *(jnp.asarray(inputs[k]) for k in (
            "speaker_latent", "speaker_mask", "text_ids", "text_mask")),
        sequence_length=SEQ, dtype=jnp.float32,
        initial_noise=jnp.asarray(inputs["noise"]), **bench.sampler_kw(STEPS))
    t = _torch(inputs)
    latents, audio = bench.generate(port, t, SEQ, STEPS, noise=t["noise"])
    np.testing.assert_allclose(latents.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(audio.numpy(), np.asarray(_j_decode(jm, want)),
                               **TOL)
    assert audio.shape == (1, SEQ * DAC_CFG.frame_length)


def test_stage_chain_matches_one_shot_and_jax(pair):
    """(d) The timed stages (prefill, sampler, decode) compute the one-shot
    request on the same noise; and JAX's stage chain."""
    jm, port = pair
    inputs = _inputs(1)
    t = _torch(inputs)
    pre = stages.prefill(port.dit, t, torch.float32)
    assert pre.kv_static[0].shape[2] == stages.TINY.text + stages.TINY.speaker \
        // DIT_CFG.speaker_patch_size
    latents = stages.sampler(port.dit, stages.step_plan(STEPS), pre, t,
                             torch.float32)
    audio = tpl.ae_decode(port, latents)
    one_lat, one_audio = bench.generate(port, t, SEQ, STEPS, noise=t["noise"])
    np.testing.assert_allclose(latents.numpy(), one_lat.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(audio.numpy(), one_audio.numpy(), atol=1e-6,
                               rtol=0)
    want = _j_chain((jm.dit_params, jm.dit_params), inputs)
    np.testing.assert_allclose(latents.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(audio.numpy(), np.asarray(_j_decode(jm, want)),
                               **TOL)


def test_int8_sampler_matches_jax(pair):
    """(e) The W8A8 sampler (the port's quantize_dit of the bf16 DiT, over
    that DiT's prefill) against JAX's run_step_segments over
    quantize_dit_params; the bf16 DiT is left unquantized."""
    jm, port = pair
    inputs = _inputs(2)
    t = _torch(inputs)
    qdit = quantize_dit(port.dit)
    pre = stages.prefill(port.dit, t, torch.float32)
    got = stages.sampler(qdit, stages.step_plan(STEPS), pre, t, torch.float32)
    want = _j_chain((jq.quantize_dit_params(jm.dit_params), jm.dit_params),
                    inputs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert dit_is_quantized(qdit) and not dit_is_quantized(port.dit)


def test_b8_rows_match_single_requests(pair):
    """(f) Row i of the B = 8 device stages against the B = 1 chain on row
    i's noise: the latents within 1e-5 (they differ by up to 4.5e-6, the
    batched products' order), and each decode slice's row i within 1e-5 of
    that row's latents decoded alone.  (The random codec carries the
    latents' difference into up to 2.1e-5 of saturated audio, so the
    slices are held on the same latents.)"""
    _, port = pair
    t = _torch(_inputs(3))
    plan = stages.step_plan(STEPS)
    inputs8 = bench.batch_inputs(t, SEQ)
    assert inputs8["noise"].shape == (bench.BATCH, SEQ, 80)
    latents8, audio8 = bench.b8_stages(port, inputs8, plan)
    assert [a.shape[0] for a in audio8] == [bench.BATCH // 2] * 2
    audio8 = torch.cat(audio8)
    for i in range(bench.BATCH):
        row = dict(t, noise=inputs8["noise"][i:i + 1])
        lat = stages.sampler(port.dit, plan,
                             stages.prefill(port.dit, row, torch.float32),
                             row, torch.float32)
        np.testing.assert_allclose(latents8[i:i + 1].numpy(), lat.numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(
            audio8[i:i + 1].numpy(),
            tpl.ae_decode(port, latents8[i:i + 1]).numpy(), atol=1e-5, rtol=0)


def test_main_prints_one_finite_line(tiny_run):
    """(g) One line, every number in it finite and above 0, and the one-shot
    DiT (blockwise=False) handed to quantize_dit still unquantized."""
    rc, lines, seen = tiny_run
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    numbers = [v for k, v in line.items() if k not in ("ranges", "card")
               and not isinstance(v, str)]
    numbers += [x for r in line["ranges"].values() for x in r]
    assert len(numbers) == 13 + 2 * len(line["ranges"])
    assert all(math.isfinite(x) and x > 0 for x in numbers)
    assert line["metric"] == "rtf_audio_sec_per_sec_per_chip"
    assert len(seen) == 1 and not seen[0].cfg.blockwise
    assert not dit_is_quantized(seen[0])


def test_a_failed_stage_exits_1_with_its_name(monkeypatch):
    """A stage whose output is not finite stops the bench: exit 1, the
    stage named on stderr, no line."""
    def nan_decode(models, latents):
        return torch.full((latents.shape[0], latents.shape[1]
                           * models.dac_cfg.frame_length), float("nan"))

    monkeypatch.setattr(bench, "ae_decode", nan_decode)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(TINY_ARGS)
    assert rc == 1 and out.getvalue() == ""
    assert err.getvalue().splitlines()[-1].startswith(
        "bench: stage one_shot: AssertionError")


def test_bench_imports_no_jax():
    """(h)"""
    code = ("import sys\n"
            "import echo_tts_torch.bench\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] == 'echo_tts_tpu']\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr
