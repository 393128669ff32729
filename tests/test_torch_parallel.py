"""The port's scale-out (echo_tts_torch/parallel/) against the JAX package
and the port's own unsharded path, on the CPU at tiny size.

Mirrors tests/test_parallel.py case for case.  The multi-rank cases run in
one gloo world of four processes (tests/torch_world.py, a dp2 x tp2 mesh
and a tp = 4 mesh over the same ranks), started once for the module: the
TP/DP sampler against JAX's unsharded sampler at atol/rtol 1e-4 (the JAX
test's bound); the W8A8 sampler under TP against the port's unsharded
W8A8 sampler at 1e-5, the int8 product's bound (JAX and the port round
near ties apart, so the W8A8 reference is the port's); SP prefill against
JAX's get_kv_cache_speaker at 1e-5 / 1e-4, and its ValueError; a tp = 4
forward with a replicated tower; the dp2 x tp2 train step (remat "full",
so that the recompute issues the all-reduces again) against the port's
one-process step, parameters after three steps at 1e-5 / 1e-4, and the
loss descending; one quant-aware distill step likewise.  The per-shard
kernel wrapper, the mesh specs and shard_params run in this process, shard
by shard.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.config import tiny_dit_config as j_tiny_dit_config
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.ops.pallas import joint_attention as jja
from echo_tts_tpu.parallel import mesh as jmesh
from echo_tts_tpu.sampler.euler import (
    sample_euler_cfg_independent_guidances as j_sample)

from echo_tts_torch.config import tiny_dit_config
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.ops import joint_attention as tja
from echo_tts_torch.ops import quant
from echo_tts_torch.parallel import mesh as pmesh
from echo_tts_torch.sampler.euler import sample_euler_cfg_independent_guidances
from echo_tts_torch.tools import bridge
from echo_tts_torch.train import distill as tdistill
from echo_tts_torch.train import step as tstep

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_dit_config()
SAMPLER_KW = dict(num_steps=2, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
                  cfg_min_t=0.5, cfg_max_t=1.0)
WORLD = 4


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(job: dict, path, world: int = WORLD) -> list:
    """Run tests/torch_world.py on `job` in a gloo world; each rank's
    results."""
    job_path = os.path.join(str(path), "job.pt")
    torch.save(job, job_path)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_world.py"),
         job_path, str(r), str(world), str(port)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [torch.load(os.path.join(str(path), f"rank{r}.pt"),
                       weights_only=True) for r in range(world)]


def _state(params, cfg):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            bridge.dit_state_from_jax(jax.tree.map(np.asarray, params),
                                      cfg).items()}


def _no_latent(params):
    """The tiny DiT's parameters without the latent encoder."""
    params = {k: v for k, v in params.items()
              if k not in ("latent_encoder", "latent_norm")}
    attn = {k: v for k, v in params["blocks"]["attn"].items()
            if k not in ("wk_latent", "wv_latent")}
    return {**params, "blocks": {**params["blocks"], "attn": attn}}


def _request(seed=1, b=4, seq=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, 16)).astype(np.int32)
    tm = np.ones((b, 16), bool)
    tm[1, 11:] = False
    spk = rng.standard_normal((b, 8, 80)).astype(np.float32)
    sm = np.ones((b, 8), bool)
    sm[2, 5:] = False
    noise = rng.standard_normal((b, seq, 80)).astype(np.float32)
    return spk, sm, ids, tm, noise


def _train_batch(seed=7, b=4, s=16, t_text=12, t_spk=8):
    rng = np.random.default_rng(seed)
    latent_mask = np.ones((b, s), bool)
    latent_mask[1, 11:] = False
    latent_mask[3, 6:] = False
    text_mask = np.ones((b, t_text), bool)
    text_mask[0, 9:] = False
    return {
        "latents": (rng.standard_normal((b, s, 80)) * 0.1).astype(np.float32),
        "text_ids": rng.integers(0, 256, (b, t_text)).astype(np.int32),
        "text_mask": text_mask,
        "speaker_latent": rng.standard_normal((b, t_spk, 80)).astype(np.float32),
        "speaker_mask": np.ones((b, t_spk), bool),
        "latent_mask": latent_mask,
    }


TP4_CFG = dataclasses.replace(CFG, text_num_heads=2)   # 2 heads: replicated


@pytest.fixture(scope="module")
def world(tiny_models, tmp_path_factory):
    """The job, and every rank's results of the one gloo world."""
    cfg_train = tiny_dit_config(blockwise=False)
    tp4 = tdit.init_dit(TP4_CFG, device="cpu", dtype=torch.float32, seed=3)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 12, 80)).astype(np.float32)
    text_mask = np.ones((2, 10), bool)
    text_mask[1, 7:] = False
    forward = (torch.from_numpy(x), torch.tensor([0.7, 0.2]),
               torch.from_numpy(rng.integers(0, 256, (2, 10)).astype(np.int32)),
               torch.from_numpy(text_mask),
               torch.from_numpy(rng.standard_normal((2, 8, 80))
                                .astype(np.float32)),
               torch.ones((2, 8), dtype=torch.bool))
    sp_latent = np.random.default_rng(31).standard_normal(
        (2, 16 * CFG.speaker_patch_size, CFG.latent_size)).astype(np.float32)
    job = {
        "cases": ["sampler", "w8a8", "tp4_forward", "sp", "train", "distill"],
        "dit": _state(tiny_models.dit_params, CFG),
        "dit_cfg": dataclasses.asdict(CFG),
        "train": _state(_no_latent(tiny_models.dit_params), cfg_train),
        "train_cfg": dataclasses.asdict(cfg_train),
        "tp4": {k: v.clone() for k, v in tp4.state_dict().items()},
        "tp4_cfg": dataclasses.asdict(TP4_CFG),
        "request": tuple(torch.from_numpy(a) for a in _request()),
        "sampler_kw": SAMPLER_KW,
        "forward": forward,
        "sp_latent": torch.from_numpy(sp_latent),
        "batch": {k: torch.from_numpy(v) for k, v in _train_batch().items()},
    }
    return job, run_world(job, tmp_path_factory.mktemp("world"))


def _rows(results, case):
    """The whole batch from the ranks' rows, each data coordinate's rows
    equal on both of its model ranks."""
    by_data = {}
    for r in results:
        dp, tp, d, m = r["coords"]
        got = r[case]
        if d in by_data:
            torch.testing.assert_close(got, by_data[d], rtol=0, atol=0)
        by_data[d] = got
    return torch.cat([by_data[d] for d in sorted(by_data)]).numpy()


def _port_model(job, name="dit"):
    from echo_tts_torch.config import EchoDiTConfig
    return bridge.load_dit_state(job[name], EchoDiTConfig(**job[f"{name}_cfg"]),
                                 device="cpu", dtype=torch.float32)


def test_mesh_shapes():
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        assert pmesh.mesh_coords(pmesh.make_mesh()) == (1, 1, 0, 0)
        with pytest.raises(ValueError, match="device count"):
            pmesh.make_mesh(dp=3, tp=3)
    finally:
        dist.destroy_process_group()


def test_tp_sampler_matches_single_device(tiny_models, world):
    """dp2 x tp2 sampling equals JAX's unsharded sampling."""
    job, results = world
    spk, sm, ids, tm, noise = _request()
    want = j_sample(tiny_models.dit_params, j_tiny_dit_config(),
                    jnp.asarray(spk), jnp.asarray(sm), jnp.asarray(ids),
                    jnp.asarray(tm), initial_noise=jnp.asarray(noise),
                    sequence_length=noise.shape[1], dtype=jnp.float32,
                    **SAMPLER_KW)
    np.testing.assert_allclose(_rows(results, "sampler"), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_tp_sampler_int8_matches_single_device(world):
    """The W8A8 DiT under TP (row-parallel products through kernel C's
    given-scale instance, their int32 sums all-reduced) against the port's
    unsharded W8A8 sampler."""
    job, results = world
    model = quant.quantize_dit(_port_model(job))
    spk, sm, ids, tm, noise = job["request"]
    want = sample_euler_cfg_independent_guidances(
        model, spk, sm, ids, tm, initial_noise=noise, dtype=torch.float32,
        sequence_length=noise.shape[1], **SAMPLER_KW)
    np.testing.assert_allclose(_rows(results, "w8a8"), want.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_tp4_forward_with_a_replicated_tower(world):
    """At tp = 4 the 2-head text encoder runs whole on every rank while the
    4-head blocks and speaker encoder shard; the forward equals the
    unsharded one on every rank."""
    job, results = world
    model = _port_model(job, "tp4")
    x, t, ids, tm, spk, sm = job["forward"]
    with torch.no_grad():
        want = tdit.dit_forward(model, x, t, tm, sm,
                                tdit.get_kv_cache_text(model, ids, tm),
                                tdit.get_kv_cache_speaker(model, spk))
    for r in results:
        assert r["tp4_forward"]["sharded"] == {
            "text_encoder": False, "speaker_encoder": True, "blocks": True}
        np.testing.assert_allclose(r["tp4_forward"]["out"].numpy(),
                                   want.numpy(), atol=2e-5, rtol=1e-4)


def test_sequence_parallel_speaker_prefill_matches_unsharded(tiny_models,
                                                             world):
    """SP prefill over tp = 4 gives JAX's get_kv_cache_speaker on every
    rank, and refuses a patch count that does not divide."""
    job, results = world
    ref_k, ref_v = jdit.get_kv_cache_speaker(
        tiny_models.dit_params, j_tiny_dit_config(),
        jnp.asarray(job["sp_latent"].numpy()))
    for r in results:
        np.testing.assert_allclose(r["sp"]["k"].numpy(), np.asarray(ref_k),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(r["sp"]["v"].numpy(), np.asarray(ref_v),
                                   atol=1e-5, rtol=1e-4)
        assert "must divide" in r["sp"]["error"]


def test_sharded_train_step_matches_single_process(world):
    """Three dp2 x tp2 train steps (remat "full") against the port's
    one-process step (remat "attn") on the same global batch and draws."""
    job, results = world
    model = _port_model(job, "train")
    tx = tstep.make_optimizer(lr=1e-3)
    state = tstep.create_train_state(model, tx)
    step = tstep.make_train_step(tx)
    gen = torch.Generator().manual_seed(5)
    losses = [float(step(state, job["batch"], gen)[1]) for _ in range(3)]
    want = state.model.state_dict()
    for r in results:
        np.testing.assert_allclose(r["train"]["losses"], losses, rtol=1e-5)
        assert set(r["train"]["params"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["train"]["params"][k].numpy(),
                                       v.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=k)
    got = results[0]["train"]["losses"]
    assert all(np.isfinite(got)) and got[2] < got[0]


def test_sharded_distill_step_matches_single_process(world):
    """One quant-aware distill step on dp2 x tp2 against one process."""
    job, results = world
    model = _port_model(job, "train")
    tx = tstep.make_optimizer(lr=1e-3)
    state = tstep.create_train_state(model, tx)
    step = tdistill.make_distill_step(tx, num_student_steps=4, substeps=2,
                                      quant_aware=True)
    gen = torch.Generator().manual_seed(6)
    _, loss = step(state, _port_model(job, "train"), job["batch"], gen)
    for r in results:
        np.testing.assert_allclose(r["distill"]["loss"], float(loss),
                                   rtol=1e-5)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(r["distill"]["params"][k].numpy(),
                                       v.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# In one process, shard by shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp,kv8", [(2, 2, False), (1, 4, False),
                                       (4, 1, False), (2, 2, True)])
def test_kernel_wrapper_per_shard(dp, tp, kv8):
    """fused_joint_attention_sharded on each shard of a (dp, tp) layout,
    reassembled, against JAX's shard_map'd kernel (interpret mode) on the
    same mesh shape: three CFG branches over a KV batch of 4, so that a
    data shard's query rows interleave across the G-major batch."""
    g, b, s, t, h, dh = 3, 4, 8, 12, 4, 16
    rng = np.random.default_rng(40 + dp + 10 * kv8)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k_self, v_self = rnd(g * b, s, h, dh), rnd(g * b, s, h, dh), rnd(
        g * b, s, h, dh)
    k_st, v_st = rnd(b, t, h, dh), rnd(b, t, h, dh)
    mask = rng.random((g * b, t)) > 0.3
    col = (1.0 + rng.random(t)).astype(np.float32)
    scales = None
    if kv8:
        k_st = np.round(k_st * 20).clip(-127, 127).astype(np.int8)
        v_st = np.round(v_st * 20).clip(-127, 127).astype(np.int8)
        scales = (rng.random((b, t, h)).astype(np.float32) * 0.05,
                  rng.random((b, t, h)).astype(np.float32) * 0.05)
    mesh = jmesh.make_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)
    want = np.asarray(jja.fused_joint_attention_sharded(
        *(jnp.asarray(a) for a in (q, k_self, v_self, k_st, v_st, mask,
                                   col)), sm_scale=dh ** -0.5, mesh=mesh,
        interpret=True,
        kv_scales=None if scales is None else tuple(map(jnp.asarray, scales))))

    tt = [torch.from_numpy(a) for a in (q, k_self, v_self, k_st, v_st, mask,
                                        col)]
    ts = None if scales is None else tuple(map(torch.from_numpy, scales))
    got = np.zeros_like(want)
    for d in range(dp):
        rows = tja.shard_query_rows(g * b, b, dp, d).numpy()
        for m in range(tp):
            out = tja.fused_joint_attention_sharded(
                *tt, sm_scale=dh ** -0.5, kv_scales=ts,
                mesh=pmesh.ShardCoords(dp, tp, d, m))
            assert out.shape == (g * b // dp, s, h // tp, dh)
            got[rows, :, m * h // tp:(m + 1) * h // tp] = out.numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_shard_query_rows_keep_cfg_branches_with_their_kv_row():
    rows = tja.shard_query_rows(12, 4, 2, 1).tolist()
    assert rows == [2, 3, 6, 7, 10, 11]
    assert all(r % 4 in (2, 3) for r in rows)
    with pytest.raises(ValueError, match="do not split"):
        z = torch.zeros((6, 2, 4, 16))
        tja.fused_joint_attention_sharded(
            z, z, z, torch.zeros((3, 5, 4, 16)), torch.zeros((3, 5, 4, 16)),
            torch.ones((6, 5), dtype=torch.bool), sm_scale=0.25,
            mesh=pmesh.ShardCoords(2, 1, 0, 0))


def test_param_specs_are_the_jax_specs_transposed():
    """Every leaf of the port's layout against JAX's dit_param_specs: a
    JAX (L, in, out) weight split on out is the port's (out, in) split on
    dim 0, one split on in is dim 1, and a (L, H, Dh) QK-norm split on H
    is the port's (H, Dh) split on H."""
    model = tdit.init_dit(CFG, device="cpu", dtype=torch.float32)
    jspecs = jmesh.dit_param_specs(blockwise=True)
    want = {(None, None, "model"): pmesh.COL, (None, "model", None): pmesh.ROW}
    towers = {"blocks": ("blocks",), "text_encoder": ("text_encoder", "blocks"),
              "speaker_encoder": ("speaker_encoder", "blocks"),
              "latent_encoder": ("latent_encoder", "blocks")}
    groups = {"attention": "attn", "mlp": "mlp"}
    n_split = 0
    for key, spec in pmesh.dit_param_specs(model).items():
        parts = key.split(".")
        if (parts[0] not in towers or parts[-3] not in groups
                or parts[-2] in ("attention_norm", "mlp_norm")):
            assert spec == pmesh.REP, key
            continue
        node = jspecs
        for p in towers[parts[0]] + (groups[parts[-3]], parts[-2]):
            node = node[p]
        jspec = tuple(node)
        if parts[-2] in ("q_norm", "k_norm"):
            assert jspec == (None, "model", None) and spec == pmesh.HEADS, key
        else:
            assert spec == want[jspec], (key, spec, jspec)
        n_split += spec != pmesh.REP
    # per layer: 10 column, wo, two QK-norms, 3 MLP in the DiT; 10 per encoder
    assert n_split == 2 * 16 + 3 * 2 * 10


@pytest.mark.parametrize("quantized", [False, True])
def test_shard_params_keeps_each_ranks_block(quantized):
    """shard_params on each rank's copy at tp = 2 keeps its block of every
    split leaf (int8 weights as the weight they replaced, a column
    scale split, a row scale whole); the blocks reassemble the model."""
    model = tdit.init_dit(CFG, device="cpu", dtype=torch.float32, seed=4)
    if quantized:
        model = quant.quantize_dit(model)
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    specs = pmesh.dit_param_specs(model, tp=2)

    def rank_copy(m):
        copy = tdit.init_dit(CFG, device="cpu", dtype=torch.float32, seed=4)
        copy = quant.quantize_dit(copy) if quantized else copy
        return pmesh.shard_params(copy, pmesh.ShardCoords(1, 2, 0, m))

    shards = [rank_copy(m).state_dict() for m in range(2)]
    for key, w in whole.items():
        spec = specs[key]
        parts = [s[key] for s in shards]
        if spec == pmesh.REP:
            for p in parts:
                torch.testing.assert_close(p, w, rtol=0, atol=0)
        else:
            dim = 1 if spec == pmesh.ROW else 0
            assert parts[0].shape[dim] * 2 == w.shape[dim], key
            torch.testing.assert_close(torch.cat(parts, dim), w, rtol=0,
                                       atol=0)
    if quantized:
        assert specs["blocks.0.attention.wq.scale"] == pmesh.COL
        assert specs["blocks.0.attention.wo.scale"] == pmesh.REP
        assert shards[0]["blocks.0.attention.wq.weight"].dtype == torch.int8


def test_towers_that_do_not_divide_stay_whole():
    model = tdit.init_dit(TP4_CFG, device="cpu", dtype=torch.float32)
    assert pmesh.sharded_towers(TP4_CFG, 4) == ("blocks.", "speaker_encoder.",
                                                "latent_encoder.")
    assert pmesh.sharded_towers(TP4_CFG, 3) == ()
    specs = pmesh.dit_param_specs(model, tp=4)
    assert specs["text_encoder.blocks.0.attention.wq.weight"] == pmesh.REP
    assert specs["blocks.0.attention.wq.weight"] == pmesh.COL
    sharded = pmesh.shard_params(model, pmesh.ShardCoords(1, 4, 0, 1))
    assert sharded.text_encoder.blocks[0].attention.wq.weight.shape == (48, 48)
    assert sharded.blocks[0].attention.wq.weight.shape == (16, 64)
    assert sharded.blocks[0].attention.q_norm.weight.shape == (1, 16)
    assert pmesh.shard_params(sharded, pmesh.ShardCoords(1, 4, 0, 1)) is sharded
    with pytest.raises(ValueError, match="before sharding"):
        quant.quantize_dit(sharded)


def test_kv_cache_and_batch_specs():
    c = pmesh.ShardCoords(dp=2, tp=4, data=1, model=3)
    assert pmesh.kv_cache_spec(c, 4, 16) == (slice(2, 4), slice(12, 16))
    assert pmesh.batch_spec(c, 6) == slice(3, 6)
    with pytest.raises(ValueError, match="must divide"):
        pmesh.batch_spec(c, 5)


def test_sharded_forward_refuses_an_unsharded_model():
    model = tdit.init_dit(CFG, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="shard it"):
        tdit.check_mesh(model, pmesh.ShardCoords(1, 2, 0, 0), 1)
    with pytest.raises(ValueError, match="num_heads % model"):
        tdit.check_mesh(model, pmesh.ShardCoords(1, 3, 0, 0), 1)


def test_port_parallel_imports_no_jax():
    code = ("import sys; import echo_tts_torch.parallel.mesh, "
            "echo_tts_torch.parallel.inference, echo_tts_torch.parallel.sp, "
            "echo_tts_torch.parallel.distributed; "
            "assert 'jax' not in sys.modules and not any("
            "m.startswith('echo_tts_tpu') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
