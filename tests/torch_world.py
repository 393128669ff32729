"""One rank of a gloo world on the CPU, for the port's multi-rank tests.

    python tests/torch_world.py <job.pt> <rank> <world size> <port>

A test writes a job (weights, inputs and the cases to run), starts one
process per rank, and compares what each rank writes to
<job dir>/rank<r>.pt with its references.  This file imports nothing of
JAX, so that a rank starts in a few seconds; the references are the
test's.
"""
import os
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)

from echo_tts_torch.config import EchoDiTConfig  # noqa: E402
from echo_tts_torch.models import dit  # noqa: E402
from echo_tts_torch.ops.quant import quantize_dit  # noqa: E402
from echo_tts_torch.parallel import inference as pinf  # noqa: E402
from echo_tts_torch.parallel import mesh as pmesh  # noqa: E402
from echo_tts_torch.parallel.sp import get_kv_cache_speaker_sp  # noqa: E402
from echo_tts_torch.sampler.euler import (  # noqa: E402
    sample_euler_cfg_independent_guidances)
from echo_tts_torch.sampler import euler  # noqa: E402
from echo_tts_torch.tools import bridge  # noqa: E402
from echo_tts_torch.train import distill as tdistill  # noqa: E402
from echo_tts_torch.train import step as tstep  # noqa: E402


def model_from(job, name="dit"):
    cfg = EchoDiTConfig(**job[f"{name}_cfg"])
    return bridge.load_dit_state(job[name], cfg, device="cpu",
                                 dtype=torch.float32)


def sample(job, model, mesh):
    spk, smask, ids, tmask, noise = pinf.place_request(
        mesh, *job["request"])
    return sample_euler_cfg_independent_guidances(
        model, spk, smask, ids, tmask, initial_noise=noise, mesh=mesh,
        dtype=torch.float32, sequence_length=noise.shape[1],
        **job["sampler_kw"])


def case_sampler(job, meshes):
    """fp32 sampling on a dp2 x tp2 mesh: the rank's rows."""
    mesh = meshes["dp2tp2"]
    return sample(job, pmesh.shard_params(model_from(job), mesh), mesh)


def case_w8a8(job, meshes):
    """The W8A8 DiT (quantized whole, then sharded) on dp2 x tp2."""
    mesh = meshes["dp2tp2"]
    model = pmesh.shard_params(quantize_dit(model_from(job)), mesh)
    return sample(job, model, mesh)


def case_tp4_forward(job, meshes):
    """One dit_forward at tp = 4 of a DiT whose text encoder has fewer
    heads than ranks (it runs replicated) and whose blocks shard."""
    mesh = meshes["tp4"]
    model = pmesh.shard_params(model_from(job, "tp4"), mesh)
    x, t, text_ids, text_mask, spk, spk_mask = job["forward"]
    with torch.no_grad():
        kv_t = dit.get_kv_cache_text(model, text_ids, text_mask, mesh)
        kv_s = dit.get_kv_cache_speaker(model, spk, mesh)
        out = dit.dit_forward(model, x, t, text_mask, spk_mask, kv_t, kv_s,
                              mesh=mesh)
    return {"out": out, "sharded": {
        name: any(pmesh.is_sharded(m) for m in getattr(model, name).modules())
        for name in ("text_encoder", "speaker_encoder", "blocks")}}


def case_sp(job, meshes):
    """Sequence-parallel speaker prefill over tp = 4, and its refusal of a
    patch count that does not divide."""
    mesh = meshes["tp4"]
    model = model_from(job)
    k, v = get_kv_cache_speaker_sp(model, job["sp_latent"], mesh)
    ps = model.cfg.speaker_patch_size
    try:
        get_kv_cache_speaker_sp(model, job["sp_latent"][:, :6 * ps], mesh)
        error = ""
    except ValueError as exc:
        error = str(exc)
    return {"k": k, "v": v, "error": error}


def _train_state(job, mesh):
    model = model_from(job, "train")
    tx = tstep.make_optimizer(lr=1e-3)
    return tx, tstep.create_train_state(model, tx, mesh=mesh)


def case_train(job, meshes):
    """Three train steps on dp2 x tp2 under remat "full" (every layer's
    all-reduces issued again in the backward's recompute), then the whole
    parameters gathered."""
    mesh = meshes["dp2tp2"]
    tx, state = _train_state(job, mesh)
    step = tstep.make_train_step(tx, remat="full", mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    losses = [float(step(state, job["batch"], gen)[1]) for _ in range(3)]
    return {"losses": losses,
            "params": pmesh.gather_params(state.model, mesh)}


def case_distill(job, meshes):
    """One quant-aware distill step on dp2 x tp2 (the QAT row-parallel
    products take their scales over the whole K)."""
    mesh = meshes["dp2tp2"]
    tx, state = _train_state(job, mesh)
    teacher = tdistill.shard_teacher(model_from(job, "train"), mesh)
    step = tdistill.make_distill_step(tx, mesh=mesh, num_student_steps=4,
                                      substeps=2, quant_aware=True)
    gen = torch.Generator().manual_seed(6)
    _, loss = step(state, teacher, job["batch"], gen)
    return {"loss": float(loss),
            "params": pmesh.gather_params(state.model, mesh)}


# ---------------------------------------------------------------------------
# The mesh cores as programs (tests/test_torch_mesh_programs.py): each
# program's miss and hit against the same body run eagerly (`.eager`)
# ---------------------------------------------------------------------------

def _counts(cache) -> tuple:
    return cache.misses, cache.hits, len(cache)


def _program_runs(cache, eager, program) -> dict:
    """eager(), then program() twice (its miss, then its hit), with the
    cache's (misses, hits, entries) before and after each call."""
    out = {"eager": eager(), "counts": [_counts(cache)]}
    for name in ("miss", "hit"):
        out[name] = program()
        out["counts"].append(_counts(cache))
    return out


def _sampler_runs(job, model, mesh) -> dict:
    placed = pinf.place_request(mesh, *job["request"])
    kw = dict(mesh=mesh, dtype=torch.float32,
              sequence_length=placed[-1].shape[1], **job["sampler_kw"])
    return _program_runs(
        euler.EULER_PROGRAMS,
        lambda: sample_euler_cfg_independent_guidances.eager(
            model, *placed[:4], initial_noise=placed[4], **kw),
        lambda: sample_euler_cfg_independent_guidances(
            model, *placed[:4], initial_noise=placed[4], **kw))


def case_prog_sampler(job, meshes):
    """The sampler's programs on dp2 x tp2 and on tp = 4 (each rank's
    rows; the whole batch at tp = 4), and the cache's mesh keys."""
    out, models = {}, []
    for name in ("dp2tp2", "tp4"):
        mesh = meshes[name]
        models.append(pmesh.shard_params(model_from(job), mesh))
        out[name] = _sampler_runs(job, models[-1], mesh)
        out[name]["mesh_key"] = _plain_key(pmesh.mesh_key(mesh))
    out["mesh_keys"] = [_plain_key(k[-1])
                        for k in euler.EULER_PROGRAMS.entries]
    return out


def _plain_key(key: tuple) -> tuple:
    """A mesh key in plain tuples (torch.load's weights_only form)."""
    kind, ident, coords = key
    return kind, ident, tuple(coords)


def case_prog_two_meshes(job, meshes):
    """One whole model, one request, one key, on two data-parallel meshes
    of one layout: a program each."""
    model = model_from(job)
    out = {name: _sampler_runs(job, model, meshes[name])
           for name in ("dp4", "dp4_again")}
    out["entries"] = len(euler.EULER_PROGRAMS)
    return out


def _optimizer_state(state) -> list:
    return [v.clone() for p in state.model.parameters()
            for k, v in sorted(state.optimizer.state[p].items())
            if k in ("exp_avg", "exp_avg_sq")]


def _state_tensors(state) -> dict:
    """The rank's parameters, AdamW moments and EMA (its shards)."""
    return {"params": [p.detach().clone() for p in state.model.parameters()],
            "moments": _optimizer_state(state),
            "ema": [p.detach().clone() for p in state.ema.parameters()]}


def case_prog_train(job, meshes):
    """Three dp2 x tp2 train steps (remat "full", an EMA) through the
    program and three through `.eager` from an identical state, on the
    same draws."""
    mesh = meshes["dp2tp2"]
    out = {}
    for form in ("program", "eager"):
        model = model_from(job, "train")
        tx = tstep.make_optimizer(lr=1e-3)
        state = tstep.create_train_state(model, tx, ema=True, mesh=mesh)
        step = tstep.make_train_step(tx, ema_decay=0.9, remat="full",
                                     mesh=mesh)
        run = step if form == "program" else step.eager
        gen = torch.Generator().manual_seed(5)
        before = _counts(tstep.TRAIN_PROGRAMS)
        losses = [run(state, job["batch"], gen)[1].clone() for _ in range(3)]
        out[form] = {"losses": torch.stack(losses),
                     "counts": [before, _counts(tstep.TRAIN_PROGRAMS)],
                     **_state_tensors(state)}
    return out


def case_prog_distill(job, meshes):
    """One quant-aware dp2 x tp2 distill step (an EMA) through the program
    and through `.eager` from an identical state."""
    mesh = meshes["dp2tp2"]
    out = {}
    for form in ("program", "eager"):
        tx = tstep.make_optimizer(lr=1e-3)
        state = tstep.create_train_state(model_from(job, "train"), tx,
                                         ema=True, mesh=mesh)
        teacher = tdistill.shard_teacher(model_from(job, "train"), mesh)
        step = tdistill.make_distill_step(tx, ema_decay=0.9, mesh=mesh,
                                          num_student_steps=4, substeps=2,
                                          quant_aware=True)
        run = step if form == "program" else step.eager
        gen = torch.Generator().manual_seed(6)
        before = _counts(tdistill.DISTILL_PROGRAMS)
        loss = run(state, teacher, job["batch"], gen)[1].clone()
        out[form] = {"loss": loss,
                     "counts": [before, _counts(tdistill.DISTILL_PROGRAMS)],
                     **_state_tensors(state)}
    return out


def case_prog_sp(job, meshes):
    """The sequence-parallel prefill's program over tp = 4."""
    from echo_tts_torch.parallel import sp
    mesh = meshes["tp4"]
    model = model_from(job)
    return _program_runs(
        sp.SP_PROGRAMS,
        lambda: get_kv_cache_speaker_sp.eager(model, job["sp_latent"], mesh),
        lambda: get_kv_cache_speaker_sp(model, job["sp_latent"], mesh))


CASES = {f.__name__[5:]: f for f in (case_sampler, case_w8a8,
                                     case_tp4_forward, case_sp, case_train,
                                     case_distill, case_prog_sampler,
                                     case_prog_two_meshes, case_prog_train,
                                     case_prog_distill, case_prog_sp)}


def main(job_path, rank, world, port):
    job = torch.load(job_path, weights_only=True)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    meshes = {"dp2tp2": pmesh.make_mesh(dp=2, tp=2),
              "tp4": pmesh.make_mesh(dp=1, tp=4)}
    for name in job.get("meshes", ()):       # more, by name: "dp4", ...
        meshes[name] = pmesh.make_mesh(dp=world, tp=1)
    out = {"coords": tuple(pmesh.mesh_coords(meshes["dp2tp2"]))}
    for name in job["cases"]:
        out[name] = CASES[name](job, meshes)
    assert "jax" not in sys.modules
    torch.save(out, os.path.join(os.path.dirname(job_path), f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:5]))
