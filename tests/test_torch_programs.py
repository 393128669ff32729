"""The port's captured programs (echo_tts_torch/utils/programs.py) on the
CPU, where the same plumbing runs without a capture: static buffers, the
copy in, the body, the clone out.

The sampler's core (sampler/euler._euler_core) and the codec's
(pipeline._encode_core, _decode_core) against the JAX package's jitted
cores on the same tiny fp32 weights, at the sampler tests' 1e-4 / 1e-3
and the codec tests' 2e-5 / 1e-4; a replayed call bit for bit its miss
run; no aliasing of a program's output; the JAX core's key fields each
separating programs; the micro-batch server's padded batch against the
unpadded rows; warmup_compile leaving exactly its manifest's
programs; and a miss recorded as one build span, a hit as none.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.pipeline import pipeline as jpl
from echo_tts_tpu.sampler import euler as jeuler

from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
from echo_tts_torch.examples import stages
from echo_tts_torch.ops import rope
from echo_tts_torch.pipeline import pipeline as tpl
from echo_tts_torch.sampler import euler as teuler
from echo_tts_torch.serve import handler as th
from echo_tts_torch.serve.batcher import BatchRequest, run_batch
from echo_tts_torch.serve.server import MicroBatchServer
from echo_tts_torch.tools import bridge
from echo_tts_torch.utils import profiling, programs

torch.set_num_threads(1)
DIT_CFG, DAC_CFG = tiny_dit_config(), tiny_dac_config()
FAST = {"num_steps": 2, "sequence_length": 8}
# the JAX core's key after the config: num_steps, the two CFG scales,
# cfg_min_t, cfg_max_t, truncation_factor, rescale_k, rescale_sigma, the
# three speaker_kv_* fields, dtype, kv_quant
KEY = dict(num_steps=4, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
           cfg_min_t=0.5, cfg_max_t=1.0, truncation_factor=None,
           rescale_k=None, rescale_sigma=None, speaker_kv_scale=None,
           speaker_kv_max_layers=None, speaker_kv_min_t=None)


def port_models(jm):
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


@pytest.fixture(autouse=True)
def fresh_programs():
    programs.clear_all()
    for cache in programs.caches():
        cache.misses = cache.hits = 0
    yield
    programs.clear_all()


def _request(seed: int, b: int = 1, seq: int = 8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, 11)).astype(np.int32)
    tmask = np.ones((b, 11), bool)
    tmask[:, 9:] = False
    spk = rng.standard_normal((b, 8, 80)).astype(np.float32)
    smask = np.ones((b, 8), bool)
    smask[:, 6:] = False
    noise = rng.standard_normal((b, seq, 80)).astype(np.float32)
    return spk, smask, ids, tmask, noise


def _core(model, dtype=torch.float32, kv_quant=False, **kw):
    k = dict(KEY, **kw)
    return teuler._euler_core(model, *k.values(), dtype, kv_quant)


@pytest.mark.parametrize("kw", [
    {}, dict(kv_quant=True),
    dict(truncation_factor=0.8, rescale_k=1.2, rescale_sigma=3.0,
         speaker_kv_scale=1.5, speaker_kv_max_layers=1, speaker_kv_min_t=0.4),
], ids=["default", "kv8", "truncation_rescale_kv_scale"])
def test_euler_core_matches_jax(pair, kw):
    """The port's core against JAX `_euler_core(...)(params, ...)` on
    injected noise; a second call at the key (the replay's plumbing) is
    the first's result bit for bit."""
    jm, port = pair
    k = dict(KEY, **{n: v for n, v in kw.items() if n != "kv_quant"})
    kv_quant = kw.get("kv_quant", False)
    run = jeuler._euler_core(jm.dit_cfg, *k.values(), jnp.float32,
                             kv_quant=kv_quant)
    inputs = _request(1)
    want = run(jm.dit_params, *map(jnp.asarray, inputs))
    core = _core(port.dit, kv_quant=kv_quant,
                 **{n: v for n, v in kw.items() if n != "kv_quant"})
    got = core(*map(torch.from_numpy, inputs))
    again = core(*map(torch.from_numpy, inputs))
    assert got.dtype == torch.float32 and got.shape == (1, 8, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)
    assert torch.equal(again, got)
    assert (teuler.EULER_PROGRAMS.misses, teuler.EULER_PROGRAMS.hits) == (1, 1)


def test_sampler_goes_through_the_core(pair):
    """sample_euler_cfg_independent_guidances without a mesh is the core:
    one program per key and shapes, its result the core's."""
    _, port = pair
    spk, smask, ids, tmask, noise = map(torch.from_numpy, _request(2))
    kw = {n: v for n, v in KEY.items() if v is not None}
    got = teuler.sample_euler_cfg_independent_guidances(
        port.dit, spk, smask, ids, tmask, sequence_length=8,
        dtype=torch.float32, initial_noise=noise, **kw)
    assert len(teuler.EULER_PROGRAMS) == 1
    assert torch.equal(got, _core(port.dit)(spk, smask, ids, tmask, noise))
    assert teuler.EULER_PROGRAMS.hits == 1


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_codec_cores_match_jax(pair, kind):
    """_encode_core and _decode_core against JAX's at the codec tests'
    bound (tests/test_torch_dac.py), twice (the second call a hit)."""
    jm, port = pair
    rng = np.random.default_rng(3)
    if kind == "encode":
        x = (0.1 * rng.standard_normal((1, 6 * DAC_CFG.frame_length, 1))
             ).astype(np.float32)
        want = jpl._encode_core(jm.dac_cfg, jnp.float32)(
            jm.dac_params, jm.pca, jnp.asarray(x))
        run = tpl._encode_core(port)
        cache = tpl.ENCODE_PROGRAMS
    else:
        x = rng.standard_normal((2, 6, 80)).astype(np.float32)
        want = jpl._decode_core(jm.dac_cfg, jnp.float32)(
            jm.dac_params, jm.pca, jnp.asarray(x))
        run = tpl._decode_core(port)
        cache = tpl.DECODE_PROGRAMS
    got = run(torch.from_numpy(x))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    assert torch.equal(run(torch.from_numpy(x)), got)
    assert (cache.misses, cache.hits, len(cache)) == (1, 1, 1)


def test_no_aliasing_of_the_static_output(pair):
    """Two calls at one key with different inputs: the first call's
    result is unchanged by the second, and a third call with the first's
    inputs gives it again in a tensor of its own."""
    _, port = pair
    core = _core(port.dit)
    a, b = _request(4), _request(5)
    first = core(*map(torch.from_numpy, a))
    kept = first.clone()
    second = core(*map(torch.from_numpy, b))
    third = core(*map(torch.from_numpy, a))
    assert torch.equal(first, kept) and not torch.equal(second, first)
    assert torch.equal(third, first) and third.data_ptr() != first.data_ptr()
    decode = tpl._decode_core(port)
    la = torch.from_numpy(_request(6)[4])
    out = decode(la)
    kept = out.clone()
    decode(la + 1.0)
    assert torch.equal(out, kept)


FIELDS = dict(num_steps=3, cfg_scale_text=2.5, cfg_scale_speaker=7.0,
              cfg_min_t=0.4, cfg_max_t=0.9, truncation_factor=0.8,
              rescale_k=1.2, rescale_sigma=3.0, speaker_kv_scale=1.5,
              speaker_kv_max_layers=1, speaker_kv_min_t=0.4,
              dtype=torch.float64, kv_quant=True)


@pytest.mark.parametrize("field", [*FIELDS, "model", "shape"])
def test_each_key_field_separates_programs(pair, monkeypatch, field):
    """Each field of the JAX core's key, changed alone, gives a new
    program; the same key gives the same program (a hit), and so does the
    first key again.  So does another model (its weights) and another
    input shape.  The body is replaced by a cheap one: the keys are the
    subject here."""
    _, port = pair
    monkeypatch.setattr(teuler, "_euler_body",
                        lambda model, *inputs, **kw: inputs[-1] * 2.0)
    inputs = list(map(torch.from_numpy, _request(7)))
    cache = teuler.EULER_PROGRAMS
    _core(port.dit)(*inputs)
    first = next(iter(cache.entries.values()))
    _core(port.dit)(*inputs)
    assert (cache.misses, cache.hits, len(cache)) == (1, 1, 1)
    model, other = port.dit, inputs
    kw = {}
    if field == "model":
        model = port_models_like(port).dit
    elif field == "shape":
        other = list(map(torch.from_numpy, _request(7, seq=12)))
    else:
        kw = {field: FIELDS[field]}
    _core(model, **kw)(*other)
    assert (cache.misses, len(cache)) == (2, 2)
    _core(port.dit)(*inputs)
    assert cache.hits == 2 and any(v is first for v in cache.entries.values())
    if field in FIELDS:
        keys = cache.keys()
        changed = [i for i, (x, y) in enumerate(zip(*keys)) if x != y]
        assert changed == [1 + list(FIELDS).index(field)]


def port_models_like(port):
    """Another DiT with port's weights: the same config, another module."""
    dit = type(port.dit)(port.dit.cfg).to(torch.float32)
    dit.load_state_dict(port.dit.state_dict())
    return dataclasses.replace(port, dit=dit.eval().requires_grad_(False))


def test_programs_hold_the_tables_they_read(pair):
    """The RoPE table a body reads is held by its program, which keeps it
    alive after its cache drops it."""
    _, port = pair
    cache = programs.ProgramCache("test-hold", 2)
    try:
        def make_body():
            return lambda owner, x: x * rope.freqs_tensor(8, 3, "cpu")[:, 0, 0]
        out = cache(("rope",), port.dit, [torch.ones(3)], make_body)
        prog = next(iter(cache.entries.values()))
        table = rope.freqs_tensor(8, 3, "cpu")
        assert any(h is table for h in prog.held.values())
        assert torch.equal(out, table[:, 0, 0])
    finally:
        programs._CACHES.remove(cache)


def test_padded_batch_equals_unpadded_rows(pair):
    """Three concurrent requests run as one pass padded to the batch bucket
    4; each request's audio is its row of the unpadded pass of three
    within 1e-5."""
    _, port = pair
    reqs = [BatchRequest(f"Padded row {i}.", seed=20 + i, request_id=str(i))
            for i in range(3)]
    want = run_batch(port, reqs, FAST)
    server = MicroBatchServer(port, max_batch=4, max_wait_s=1.0)
    try:
        futs = [server.submit(r, FAST) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
    finally:
        server.shutdown()
    assert server.stats()["batches"] == 1
    # the pass ran at four rows: one program at B = 3, one at B = 4
    rows = sorted(k[3][-1][0][0] for k in teuler.EULER_PROGRAMS.entries)
    assert rows == [3, 4]
    for g, w in zip(got, want):
        assert g.request_id == w.request_id
        np.testing.assert_allclose(g.audio, w.audio, atol=1e-5, rtol=0)


def test_warmup_compile_leaves_the_manifest_programs(pair, monkeypatch):
    """warmup_compile over a two-entry manifest (one-shot without a
    speaker, a batch of 2) leaves exactly their programs: the sampler at B
    = 1 and 2, their decodes, and the 640-latent voice encode; a second
    pass makes none."""
    _, port = pair
    monkeypatch.setattr(th, "SAMPLER_DEFAULTS", {**th.SAMPLER_DEFAULTS, **FAST})
    manifest = [
        {"kind": "oneshot", "text_bucket": 768, "speaker_bucket": None,
         "sequence_length": 8},
        {"kind": "batch", "batch_size": 2, "speaker_bucket": None,
         "sequence_length": 8}]
    report = th.warmup_compile(port, FAST, manifest=manifest)
    assert [r["entry"] for r in report[1:]] == manifest
    # the last input's shape: the sampler's noise, the codec's audio or
    # latents
    shapes = {c.name: sorted(k[3][-1][0] for k in c.entries)
              for c in programs.caches() if len(c)}
    spl = DAC_CFG.frame_length
    assert shapes == {"euler": [(1, 8, 80), (2, 8, 80)],
                      "encode": [(1, 640 * spl, 1)],
                      "decode": [(1, 8, 80), (2, 8, 80)]}
    keys = teuler.EULER_PROGRAMS.keys()
    assert len(set(keys)) == 1 and keys[0][1] == FAST["num_steps"]
    misses = {c.name: c.misses for c in programs.caches()}
    th.warmup_compile(port, FAST, manifest=manifest)
    assert {c.name: c.misses for c in programs.caches()} == misses


def test_stage_programs_match_the_serving_sampler(pair):
    """The bench's prefill and sampler stages, each a program, chain to the
    serving core's latents (tests/test_torch_bench.py holds the chain
    against JAX); their second calls are hits."""
    _, port = pair
    spk, smask, ids, tmask, noise = map(torch.from_numpy, _request(8))
    inputs = dict(speaker_latent=spk, speaker_mask=smask, text_ids=ids,
                  text_mask=tmask, noise=noise)
    plan = stages.step_plan(KEY["num_steps"])
    for _ in range(2):
        pre = stages.prefill(port.dit, inputs, torch.float32)
        lat = stages.sampler(port.dit, plan, pre, inputs, torch.float32)
    want = _core(port.dit)(spk, smask, ids, tmask, noise)
    np.testing.assert_allclose(lat.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert (stages.STAGE_PROGRAMS.misses, stages.STAGE_PROGRAMS.hits) == (2, 2)


def test_a_miss_records_one_build_span_and_a_hit_none(pair):
    """A miss is one `program.build` span, named by its cache and key (its
    eager run, and on a card its capture as a `program.capture` child);
    a hit records none."""
    _, port = pair
    cache = programs.ProgramCache("test-spans", 2)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    try:
        mark = profiling.now_ns()
        cache(("k",), port.dit, [torch.ones(3, device=dev)],
              lambda: (lambda owner, x: x * 2.0))
        (build,) = programs.builds(mark)
        assert build.attrs == {"cache": "test-spans", "key": ("k",)}
        captures = [s for s in profiling.spans(mark)
                    if s.name == "program.capture"]
        assert [c.parent for c in captures] == ([build.id] if dev == "cuda"
                                                else [])
        mark = profiling.now_ns()
        cache(("k",), port.dit, [torch.ones(3, device=dev)],
              lambda: (lambda owner, x: x * 2.0))
        assert cache.hits == 1 and programs.builds(mark) == []
        assert not [s for s in profiling.spans(mark)
                    if s.name.startswith("program.")]
    finally:
        programs._CACHES.remove(cache)
