"""The mesh cores as captured programs (echo_tts_torch/utils/programs.py,
"Scoped programs"; echo_tts_torch/parallel/mesh.py, "Programs over a mesh")
on the CPU, at the tiny config in fp32.

One gloo world of four processes (tests/torch_world.py, no JAX), started
once for the module, runs each mesh core three ways on every rank: its
body without the program (`.eager`), then the program's miss, then its
hit.  On the CPU nothing is captured, so the program's plumbing (static
buffers, copy in, the body, clone out, the key) is what is held: the
miss and the hit equal the eager body bit for bit, the hit makes no new
program, and each mesh keys programs of its own.  The cores: the Euler
sampler on dp2 x tp2 (its rows also against JAX's unsharded sampler at
1e-4, test_torch_parallel.py's bound) and at tp = 4; one model on two
data-parallel meshes of one layout; three dp2 x tp2 train steps (remat
"full", an EMA) and one quant-aware distill step, against `.eager` on an
identical state (loss, parameters, AdamW moments, EMA); the sequence-
parallel speaker prefill over tp = 4 (also within 1e-5 of the unsharded
get_kv_cache_speaker).  In this process: the refusal of a mesh that is
not NCCL on a card (its predicate, parallel.mesh.capture_refusal), the
mesh key, parallel.mesh.drop_programs and parallel.distributed.shutdown.
"""
import dataclasses
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from echo_tts_tpu.config import tiny_dit_config as j_tiny_dit_config
from echo_tts_tpu.sampler.euler import (
    sample_euler_cfg_independent_guidances as j_sample)

from echo_tts_torch.config import tiny_dit_config
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.parallel import distributed as pdist
from echo_tts_torch.parallel import mesh as pmesh
from echo_tts_torch.utils import programs
from test_torch_parallel import (CFG, SAMPLER_KW, _no_latent, _request,
                                 _state, _train_batch, run_world)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tiny_models, tmp_path_factory):
    """The job, and every rank's results of the one gloo world."""
    cfg_train = tiny_dit_config(blockwise=False)
    sp_latent = np.random.default_rng(32).standard_normal(
        (2, 16 * CFG.speaker_patch_size, CFG.latent_size)).astype(np.float32)
    job = {
        "cases": ["prog_sampler", "prog_two_meshes", "prog_train",
                  "prog_distill", "prog_sp"],
        "meshes": ["dp4", "dp4_again"],
        "dit": _state(tiny_models.dit_params, CFG),
        "dit_cfg": dataclasses.asdict(CFG),
        "train": _state(_no_latent(tiny_models.dit_params), cfg_train),
        "train_cfg": dataclasses.asdict(cfg_train),
        "request": tuple(torch.from_numpy(a) for a in _request(seed=2)),
        "sampler_kw": SAMPLER_KW,
        "sp_latent": torch.from_numpy(sp_latent),
        "batch": {k: torch.from_numpy(v)
                  for k, v in _train_batch(seed=8).items()},
    }
    return job, run_world(job, tmp_path_factory.mktemp("mesh_programs"))


def _same(got, want) -> bool:
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(map(_same, got, want))
    return got.dtype == want.dtype and torch.equal(got, want)


def _miss_then_hit(runs) -> None:
    """A miss (a new program) and then a hit (no new one), both the eager
    body's result bit for bit; the eager body made no program."""
    (m0, h0, n0), (m1, h1, n1), (m2, h2, n2) = runs["counts"]
    assert (m1, h1) == (m0 + 1, h0) and n1 >= 1
    assert (m2, h2, n2) == (m1, h1 + 1, n1)
    assert _same(runs["miss"], runs["eager"])
    assert _same(runs["hit"], runs["eager"])


@pytest.mark.parametrize("mesh", ["dp2tp2", "tp4"])
def test_sampler_program_is_its_eager_body(world, mesh):
    _, results = world
    for r in results:
        _miss_then_hit(r["prog_sampler"][mesh])


def test_sampler_program_rows_match_jax(tiny_models, world):
    """The dp2 x tp2 program's rows, reassembled, against JAX's unsharded
    sampler on the same numpy noise."""
    job, results = world
    spk, sm, ids, tm, noise = _request(seed=2)
    want = j_sample(tiny_models.dit_params, j_tiny_dit_config(),
                    jnp.asarray(spk), jnp.asarray(sm), jnp.asarray(ids),
                    jnp.asarray(tm), initial_noise=jnp.asarray(noise),
                    sequence_length=noise.shape[1], dtype=jnp.float32,
                    **SAMPLER_KW)
    by_data = {}
    for r in results:
        got = r["prog_sampler"]["dp2tp2"]["hit"]
        data = r["coords"][2]
        if data in by_data:      # both model ranks of a data coordinate
            assert torch.equal(got, by_data[data])
        by_data[data] = got
    rows = torch.cat([by_data[d] for d in sorted(by_data)]).numpy()
    np.testing.assert_allclose(rows, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_each_mesh_keys_its_own_sampler_program(world):
    """The dp2 x tp2 and tp = 4 programs live side by side, each keyed by
    its mesh's identity and this rank's coordinates."""
    _, results = world
    for r in results:
        out = r["prog_sampler"]
        keys = [out[m]["mesh_key"] for m in ("dp2tp2", "tp4")]
        assert sorted(out["mesh_keys"]) == sorted(keys)
        data, model = r["coords"][2:]
        assert keys[0][2] == (2, 2, data, model)
        assert keys[1][2] == (1, 4, 0, 2 * data + model)


def test_equal_meshes_do_not_share_a_program(world):
    """One model, one request and one key on two meshes of one layout (dp
    = 4): two programs, each its eager body's result."""
    _, results = world
    for r in results:
        out = r["prog_two_meshes"]
        for name in ("dp4", "dp4_again"):
            _miss_then_hit(out[name])
        assert out["dp4_again"]["counts"][1][0] == (
            out["dp4"]["counts"][2][0] + 1)
        assert out["entries"] == 2
        assert torch.equal(out["dp4"]["hit"], out["dp4_again"]["hit"])


def _same_state(got: dict, want: dict) -> None:
    for part in ("params", "moments", "ema"):
        assert len(got[part]) == len(want[part]) > 0, part
        assert all(map(torch.equal, got[part], want[part])), part


def test_train_program_is_its_eager_body(world):
    """Three dp2 x tp2 train steps through the program (one miss, then
    hits) and three through `.eager` from an identical state: losses,
    the rank's parameters, AdamW moments and EMA bit for bit."""
    _, results = world
    for r in results:
        out = r["prog_train"]
        prog, eager = out["program"], out["eager"]
        (m0, h0, _), (m1, h1, n1) = prog["counts"]
        assert (m1 - m0, h1 - h0) == (1, 2) and n1 >= 1
        assert eager["counts"][0][:2] == eager["counts"][1][:2]
        assert torch.equal(prog["losses"], eager["losses"])
        assert bool(torch.isfinite(prog["losses"]).all())
        _same_state(prog, eager)


def test_distill_program_is_its_eager_body(world):
    """One quant-aware dp2 x tp2 distill step through the program and
    through `.eager`: loss, parameters, moments and EMA bit for bit."""
    _, results = world
    for r in results:
        out = r["prog_distill"]
        prog, eager = out["program"], out["eager"]
        (m0, _, _), (m1, _, _) = prog["counts"]
        assert m1 == m0 + 1
        assert eager["counts"][0] == eager["counts"][1]
        assert torch.equal(prog["loss"], eager["loss"])
        _same_state(prog, eager)


def test_sp_program_is_its_eager_body_and_the_unsharded_prefill(world):
    """The tp = 4 prefill's program bit for bit its eager body on every
    rank, and within 1e-5 of get_kv_cache_speaker on the whole model."""
    from echo_tts_torch.tools import bridge
    job, results = world
    model = bridge.load_dit_state(job["dit"], CFG, device="cpu",
                                  dtype=torch.float32)
    with torch.no_grad():
        want = tdit.get_kv_cache_speaker(model, job["sp_latent"])
    for r in results:
        runs = r["prog_sp"]
        _miss_then_hit(runs)
        for got, ref in zip(runs["hit"], want):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_mesh():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield pmesh.make_mesh()
    finally:
        dist.destroy_process_group()


def test_a_gloo_mesh_is_refused_on_a_card(gloo_mesh):
    """A card cannot capture gloo's collectives: the refusal names the
    backend.  The CPU, no mesh and a ShardCoords (no process group) are
    never refused."""
    assert pmesh.mesh_backends(gloo_mesh) == ("gloo", "gloo")
    why = pmesh.capture_refusal(gloo_mesh, torch.device("cuda", 0))
    assert "'gloo'" in why and ".eager" in why
    with pytest.raises(RuntimeError, match="'gloo'"):
        pmesh.program_scope(gloo_mesh).check(torch.device("cuda", 0))
    assert pmesh.capture_refusal(gloo_mesh, "cpu") is None
    assert pmesh.capture_refusal(None, "cuda") is None
    assert pmesh.capture_refusal(pmesh.ShardCoords(1, 2, 0, 1),
                                 "cuda") is None


def test_a_gloo_mesh_runs_its_program_on_the_cpu(gloo_mesh):
    """On the CPU a program over a gloo mesh runs its body (a collective
    among it) on every call; the program holds its mesh."""
    cache = programs.ProgramCache("test_gloo_mesh", 2)
    owner = torch.nn.Linear(1, 1)

    def body(_, x):
        y = x * 2.0
        dist.all_reduce(y, group=gloo_mesh.get_group(pmesh.DATA_AXIS))
        return y

    x = torch.arange(4.0)
    for _ in range(2):
        assert torch.equal(cache((), owner, (x,), lambda: body,
                                 scope=pmesh.program_scope(gloo_mesh)),
                           x * 2.0)
    assert (cache.misses, cache.hits) == (1, 1)
    assert next(iter(cache.entries.values())).scope.mesh is gloo_mesh
    programs._CACHES.remove(cache)


def test_the_mesh_is_part_of_the_key():
    """One key, owner and input on no mesh and on two coordinates of one
    layout: three programs; the same coordinates again: a hit."""
    cache = programs.ProgramCache("test_mesh_key", 4)
    owner = torch.nn.Linear(1, 1)
    x = torch.ones(3)
    meshes = [None] + [pmesh.ShardCoords(1, 2, 0, m) for m in (0, 1, 1)]
    for mesh in meshes:
        cache(("k",), owner, (x,), lambda: lambda _, t: t + 1,
              scope=pmesh.program_scope(mesh))
    assert (cache.misses, cache.hits, len(cache)) == (3, 1, 3)
    assert pmesh.mesh_key(meshes[1]) == ("coords", meshes[1])
    programs._CACHES.remove(cache)


def test_drop_mesh_programs_leaves_the_others():
    """parallel.mesh.drop_programs, run before a process group is
    destroyed, drops the programs over a mesh and keeps those without
    one."""
    cache = programs.ProgramCache("test_drop_mesh", 4)
    owner = torch.nn.Linear(1, 1)
    x = torch.ones(3)
    for mesh in (None, pmesh.ShardCoords(1, 2, 0, 1)):
        cache(("k",), owner, (x,), lambda: lambda _, t: t * 3,
              scope=pmesh.program_scope(mesh))
    assert len(cache) == 2
    pmesh.drop_programs()
    assert [k[-1] for k in cache.entries] == [None]
    programs._CACHES.remove(cache)


def test_shutdown_drops_the_mesh_programs_then_the_group():
    """parallel.distributed.shutdown leaves the world: the programs over
    its mesh go first, then the process group; a second call (no group)
    does nothing.  The first mesh scope registers drop_programs to run at
    exit, for a process that never calls shutdown."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    cache = programs.ProgramCache("test_shutdown", 2)
    owner = torch.nn.Linear(1, 1)
    mesh = pmesh.make_mesh()
    cache(("k",), owner, (torch.ones(2),), lambda: lambda _, t: t - 1,
          scope=pmesh.program_scope(mesh))
    assert pmesh._AT_EXIT and len(cache) == 1
    pdist.shutdown()
    assert len(cache) == 0 and not dist.is_initialized()
    pdist.shutdown()
    programs._CACHES.remove(cache)
