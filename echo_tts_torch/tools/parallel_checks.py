"""Tensor-, data- and sequence-parallel runs at full width against the
unsharded ones, over the cards of one host, through the mesh cores'
programs.

    python -m echo_tts_torch.tools.parallel_checks [--depth 4]

One process per card (torch.multiprocessing spawn), joined over NCCL on
localhost; needs four cards.  Every rank builds the published DiT from
seed 0 (seeded random bf16 weights; init_dit is deterministic), computes
its unsharded references on its own card (through the one-card programs),
then shards and compares, in this order:

  collectives   a program of one all_reduce and one all_gather_into_tensor
                on the four-rank world, against its body;
  tp4           one CFG forward (GB = 3, S = 640) at tp = 4: the 10-head
                text and speaker encoders run replicated, the DiT at 4 of
                its 16 heads a rank; bf16 and the W8A8 DiT (row-parallel
                products through kernel C's given-scale instance), each
                against its unsharded forward;
  tp4_sample    the latency case tensor parallelism is for: a B = 1
                request (the first row of dp2tp2's), 40 Euler steps at tp =
                4, against the one-card program's latents and the fp32
                pass;
  tp4_w8a8_sample the same request through the W8A8 DiT at tp = 4 (kernel
                C's fused instance in the column-parallel products, its
                given-scale instance between the MAX and int32 all-reduces
                in the row-parallel ones, all inside the graph) against
                the one-card W8A8 program's latents and the fp32 pass;
  dp2tp2_sample a B = 2 request, 40 Euler steps, on a dp2 x tp2 mesh
                against the unsharded B = 2 pass: each rank's row, the
                noise rows bit for bit;
  dp2tp2_train  one train step of the DiT cut to --depth layers (encoders
                2) at B = 2 against the one-card step, and one more;
  dp2tp2_distill one distill step of the same DiT against the one-card
                step, and one more;
  sp4           the 6400-latent speaker prefill split four ways over the
                patch axis against get_kv_cache_speaker.

Every mesh core runs through its program (utils/programs.py, "Programs
over a mesh"), the NCCL collectives captured with kernels A and C: the
sampler, the prefill and the steps each run first as their body without
the program (`.eager`), then through the program twice, its miss (the
eager run and the capture) and a replay, and each program call must be
the eager body's result bit for bit on the same rank (for the steps:
loss, parameters, AdamW moments and EMA after each step, from identical
states).  Each rank reports host-clock wall milliseconds between
synchronises of the eager, the missed and the replayed calls, its
programs' build seconds (the eager run and the capture,
utils/programs.builds) and the graph pool's bytes.  At the end every rank
leaves the world through parallel.distributed.shutdown (the mesh
programs, then the process group) and says so.

chip_smoke.py's request (o) runs the same functions with two ranks on one
card over gloo, whose collectives no graph can capture: there they take
the eager forms (eager=True).  Distances are rel-RMS.  Each rank prints
each check's numbers as it ends.  A rank still running RANK_LIMIT_S
seconds after it started prints every thread's stack and exits; the main
process waits for the ranks until then, and for TEARDOWN_S seconds once
rank 0 has written the results, and then has each rank still alive print
its stacks (SIGUSR1) and ends it: a hang names its place and fails the
run, which still ends with its JSON line.  The main process prints the
card's name and power limit, each rank's times, and as its last line one
JSON object with every number.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import datetime
import faulthandler
import json
import os
import signal
import socket
import sys
import time

import torch
import torch.distributed as dist

from ..config import SAMPLER_DEFAULTS, base_dit_config
from ..device import card_names
from ..models import dit as tdit
from ..models.plain import plain_kernels
from ..ops import quant
from ..ops.int8_matmul import int8_matmul_fused, int8_matmul_partial
from ..ops.joint_attention import fused_joint_attention
from ..parallel import distributed as pdist
from ..parallel import inference as pinf
from ..parallel import mesh as pmesh
from ..parallel.sp import get_kv_cache_speaker_sp
from ..pipeline.text import get_text_input_ids_and_mask
from ..sampler.euler import (make_cfg_branch_masks,
                             sample_euler_cfg_independent_guidances)
from ..train import distill as tdistill
from ..train import step as tstep
from ..utils import profiling, programs

TEXTS = ("The quick brown fox jumps over the lazy dog, then reads it a "
         "bedtime story.", "Good morning, and welcome to the station.")
SP_LATENTS = 6400            # the longest speaker bucket: 1600 patches


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError("non-finite values")
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


def launches() -> dict:
    return {"joint_attention": fused_joint_attention.launches,
            "int8_matmul": int8_matmul_fused.launches,
            "int8_matmul_partial": int8_matmul_partial.launches}


def reset_launches() -> None:
    fused_joint_attention.launches = 0
    int8_matmul_fused.launches = 0
    int8_matmul_partial.launches = 0


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def request_inputs(device, batch: int = 1, seed: int = 7) -> dict:
    """A B-row request: TEXTS' first `batch` prompts (768 bytes), seeded
    640-latent speakers (the second row's valid for 300), and the noise
    (B, 640, 80) drawn as the serving sampler draws it (one generator
    seeded `seed` on the card)."""
    ids, tmask = get_text_input_ids_and_mask(list(TEXTS[:batch]), 768)
    g = torch.Generator(device=device).manual_seed(seed)
    spk = torch.randn((batch, 640, 80), generator=g, device=device)
    smask = torch.ones((batch, 640), dtype=torch.bool, device=device)
    smask[1:, 300:] = False
    noise = torch.randn((batch, 640, 80), generator=g, device=device)
    return dict(spk=spk, smask=smask, ids=torch.from_numpy(ids).to(device),
                tmask=torch.from_numpy(tmask).to(device), noise=noise)


def sample(model, req: dict, mesh=None, eager: bool = False
           ) -> torch.Tensor:
    """The request's 40-step latents through the serving sampler (the
    rank's rows under a mesh); eager=True runs its body without the
    program."""
    spk, smask, ids, tmask, noise = (req[k] for k in ("spk", "smask", "ids",
                                                      "tmask", "noise"))
    if mesh is not None:
        spk, smask, ids, tmask, noise = pinf.place_request(
            mesh, spk, smask, ids, tmask, noise)
    kw = dict(SAMPLER_DEFAULTS)
    kw.pop("sequence_length")
    fn = sample_euler_cfg_independent_guidances
    return (fn.eager if eager else fn)(
        model, spk, smask, ids, tmask, initial_noise=noise, mesh=mesh,
        dtype=next(model.parameters()).dtype,
        sequence_length=noise.shape[1], **kw)


def same(got, want) -> bool:
    """Bit for bit: tensors, or tuples and lists of them."""
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(map(same, got, want))
    return got.dtype == want.dtype and bool(torch.equal(got, want))


def program_check(eager_fn, program_fn, device) -> tuple:
    """eager_fn() (a mesh core's body without its program), then
    program_fn() three times: its miss (the eager run and the capture) and
    two replays.  Returns (the last replay's result, the record: wall ms
    of each call, whether the miss and the replays are the eager result
    bit for bit, the builds' seconds and the pool's bytes after)."""
    want, eager_ms = wall_ms(eager_fn)
    mark = profiling.now_ns()
    got, miss_ms = wall_ms(program_fn)
    rec = dict(eager_ms=eager_ms, miss_ms=miss_ms, replay_ms=[],
               miss_bit_equal=same(got, want))
    equal = True
    for _ in range(2):
        reset_launches()
        got, ms = wall_ms(program_fn)
        rec["replay_ms"].append(ms)
        equal = equal and same(got, want)
    built = programs.builds(mark)
    rec.update(launches=launches(), replay_bit_equal=equal,
               builds=len(built), build_s=sum(b.seconds for b in built),
               pool_bytes=programs.pool_bytes(device))
    return got, rec


@torch.inference_mode()
def cfg_forward(model, req: dict, mesh=None, seed: int = 50) -> torch.Tensor:
    """One CFG dit_forward_static (GB = 3, S = 640, t = 0.7) over the
    request's first row, the prefill included (under a mesh, the rank's
    heads through every collective), in the model's dtype from the same
    bf16 inputs."""
    dev = req["ids"].device
    dtype = next(model.parameters()).dtype
    kv_t = tdit.get_kv_cache_text(model, req["ids"][:1], req["tmask"][:1], mesh)
    kv_s = tdit.get_kv_cache_speaker(model, req["spk"][:1].to(dtype), mesh)
    kv, spk_cols = tdit.concat_static_kv(kv_t, kv_s)
    mask_cfg, _ = make_cfg_branch_masks(model.cfg, req["tmask"][:1],
                                        req["smask"][:1])
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((3, 640, 80), generator=g, device=dev).bfloat16().to(dtype)
    t = torch.full((3,), 0.7, device=dev).bfloat16().to(dtype)
    return tdit.dit_forward_static(model, x, t, kv, spk_cols, mask_cfg,
                                   mesh=mesh)


@torch.inference_mode()
def rowpar_w8a8_exact(w8a8, mesh, seed: int = 51) -> bool:
    """Layer 0's w2 (K = 5888) as one W8A8 product on the whole model and
    as this rank's row-parallel K-slice of it (the row scale over the
    whole K, kernel C's given-scale instance, the int32 all-reduce, one
    rescale): bit for bit the same.  Call it on the whole model; the
    slice is the one shard_params keeps."""
    w2 = w8a8.blocks[0].mlp.w2
    n, k = w2.weight.shape
    dev = w2.weight.device
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((3 * 640, k), generator=g, device=dev).bfloat16()
    whole = quant.int8_dot(x, w2.weight, w2.scale)
    ks = pmesh.to_named({"w": pmesh.ROW}, mesh, {"w": (n, k)})["w"][1]
    part = quant.int8_dot_row_parallel(x[:, ks], w2.weight[:, ks], w2.scale,
                                       pmesh.model_group(mesh))
    return bool(torch.equal(part, whole))


def tp_forward_check(model, mesh, req: dict, fp32_ref=None,
                     w8a8=None) -> dict:
    """bf16 and W8A8 CFG forwards at the mesh's tp against the unsharded
    ones, and, given the fp32 forward `fp32_ref`, each one's distance from
    it beside the unsharded one's; and `rowpar_w8a8_exact`.  `model`
    (whole) is sharded in place; the W8A8 model is `w8a8` (whole, a
    quantized copy of `model`), sharded in place too, or else a quantized
    copy made here and freed after."""
    if w8a8 is None:
        w8a8 = quant.quantize_dit(copy.deepcopy(model))
    ref = cfg_forward(model, req)
    ref_q = cfg_forward(w8a8, req)
    exact = rowpar_w8a8_exact(w8a8, mesh)
    pmesh.shard_params(model, mesh)
    pmesh.shard_params(w8a8, mesh)
    reset_launches()
    got, ms = wall_ms(lambda: cfg_forward(model, req, mesh))
    bf16 = launches()
    reset_launches()
    got_q, ms_q = wall_ms(lambda: cfg_forward(w8a8, req, mesh))
    q = launches()
    del w8a8
    out = dict(rel_rms=rel_rms(got, ref), ms=ms, launches=bf16,
               w8a8_rel_rms=rel_rms(got_q, ref_q), w8a8_ms=ms_q,
               w8a8_launches=q, w8a8_vs_bf16=rel_rms(ref_q, ref),
               w8a8_rowpar_exact=exact,
               local_heads=model.blocks[0].attention.q_norm.weight.shape[0])
    if fp32_ref is not None:
        out.update(rel_rms_vs_fp32=rel_rms(got, fp32_ref),
                   unsharded_vs_fp32=rel_rms(ref, fp32_ref),
                   w8a8_vs_fp32=rel_rms(got_q, fp32_ref),
                   w8a8_unsharded_vs_fp32=rel_rms(ref_q, fp32_ref))
    return out


def collectives_check(mesh, owner, seed: int = 70) -> dict:
    """A program over `mesh` (its owner `owner`, whose device it runs on)
    whose body runs dist.all_reduce and then dist.all_gather_into_tensor
    on the world group: its miss and then a replay, each on new inputs,
    against the body run eagerly on the same inputs (miss_bit_equal,
    replay_bit_equal), and the build's seconds."""
    world = dist.get_world_size()

    def body(_, x):
        y = x * 2.0 + 1.0
        dist.all_reduce(y)
        out = y.new_empty((world * y.shape[0], *y.shape[1:]))
        dist.all_gather_into_tensor(out, y)
        return out - x.repeat(world, 1)

    cache = programs.ProgramCache("collectives", 1)
    dev = next(owner.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed + dist.get_rank())
    mark = profiling.now_ns()
    rec = {}
    try:
        for name in ("miss_bit_equal", "replay_bit_equal"):
            x = torch.randn((256, 4096), generator=g, device=dev)
            want = body(None, x.clone())
            rec[name] = same(cache((), owner, (x,), lambda: body,
                                   scope=pmesh.program_scope(mesh)), want)
    finally:
        cache.clear()
        programs._CACHES.remove(cache)
    built = programs.builds(mark)
    return dict(rec, builds=len(built),
                build_s=sum(b.seconds for b in built))


def sp_check(model, mesh, seed: int = 8, eager: bool = False) -> dict:
    """The SP_LATENTS speaker prefill split over the model axis against
    get_kv_cache_speaker on the whole model: through its program
    (program_check), or with eager=True its body alone."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    lat = torch.randn((1, SP_LATENTS, 80), generator=g,
                      device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        (ref_k, ref_v), ref_ms = wall_ms(
            lambda: tdit.get_kv_cache_speaker(model, lat))
    run = lambda: get_kv_cache_speaker_sp.eager(  # noqa: E731
        model, lat, mesh)
    if eager:
        (k, v), ms = wall_ms(run)
        rec = {}
    else:
        (k, v), rec = program_check(
            run, lambda: get_kv_cache_speaker_sp(model, lat, mesh), dev)
        ms = rec["replay_ms"][-1]
    return dict(k_rel_rms=rel_rms(k, ref_k), v_rel_rms=rel_rms(v, ref_v),
                ms=ms, unsharded_ms=ref_ms, **rec)


def dp_sample_check(model, mesh, req: dict, ref: torch.Tensor,
                    fp32_ref=None, eager: bool = False) -> dict:
    """The request's rows of the rank's data coordinate against the
    unsharded pass `ref` (B, 640, 80), and, given the fp32 pass
    `fp32_ref`, each one's distance from it; its noise rows bit for bit.
    Through the sampler's program (program_check; `launches` are one
    replay's), or with eager=True its body alone.  With tp > 1 and dp = 1
    it is the tensor-parallel sampler."""
    rows = pmesh.batch_spec(mesh, req["noise"].shape[0])
    noise = pinf.place_request(mesh, req["spk"], req["smask"], req["ids"],
                               req["tmask"], req["noise"])[-1]
    run = lambda: sample(model, req, mesh, eager=True)  # noqa: E731
    if eager:
        reset_launches()
        got, ms = wall_ms(run)
        rec = dict(launches=launches())
    else:
        got, rec = program_check(run, lambda: sample(model, req, mesh),
                                 noise.device)
        ms = rec["replay_ms"][-1]
    out = dict(rel_rms=rel_rms(got, ref[rows]), ms=ms,
               rows=[rows.start, rows.stop],
               noise_bit_equal=bool(torch.equal(noise, req["noise"][rows])),
               **rec)
    if fp32_ref is not None:
        out.update(rel_rms_vs_fp32=rel_rms(got, fp32_ref[rows]),
                   unsharded_vs_fp32=rel_rms(ref[rows], fp32_ref[rows]))
    return out


def w8a8_sample_check(w8a8, mesh, req: dict, ref_q: torch.Tensor,
                      fp32_ref: torch.Tensor) -> dict:
    """The request's rows of the rank's data coordinate through the W8A8
    DiT (sharded to the mesh) and the sampler's program (program_check):
    against the one-card W8A8 program's latents `ref_q`
    (w8a8_rel_rms), and each one's distance from the fp32 pass
    `fp32_ref`; whether a replay launched both instances of kernel C."""
    rows = pmesh.batch_spec(mesh, req["noise"].shape[0])
    got, rec = program_check(lambda: sample(w8a8, req, mesh, eager=True),
                             lambda: sample(w8a8, req, mesh),
                             req["noise"].device)
    n = rec["launches"]
    return dict(w8a8_rel_rms=rel_rms(got, ref_q[rows]),
                ms=rec["replay_ms"][-1],
                kernel_c_replayed=n["int8_matmul"] > 0
                and n["int8_matmul_partial"] > 0,
                w8a8_vs_fp32=rel_rms(got, fp32_ref[rows]),
                w8a8_unsharded_vs_fp32=rel_rms(ref_q[rows], fp32_ref[rows]),
                **rec)


@torch.inference_mode()
def fp32_refs(model, req: dict) -> tuple:
    """The fp32 copy of `model` (plain attention): its 40-step latents on
    `req` and its CFG forward."""
    fp32 = copy.deepcopy(model).float()
    with plain_kernels():
        return sample(fp32, req), cfg_forward(fp32, req)


# gates of a rank's results (chip_smoke.py says why each is what it is)
REL_RMS_BOUND = 1e-2
TP_FP32_RATIO = 1.1
W8A8_FP32_RATIO = 1.25


def failures(res: dict) -> dict:
    """{check: (distance, bound)} of the checks in `res` that fail."""
    checks = {}
    for key, r in res.items():
        if not isinstance(r, dict):
            continue
        if "k_rel_rms" in r:
            checks[key] = (max(r["k_rel_rms"], r["v_rel_rms"]), REL_RMS_BOUND)
        if "rel_rms_vs_fp32" in r:
            checks[key] = (r["rel_rms_vs_fp32"],
                           TP_FP32_RATIO * r["unsharded_vs_fp32"])
        elif "rel_rms" in r:
            checks[key] = (r["rel_rms"], REL_RMS_BOUND)
        if "w8a8_vs_fp32" in r:
            checks[f"{key}_w8a8"] = (r["w8a8_vs_fp32"], W8A8_FP32_RATIO
                                     * r["w8a8_unsharded_vs_fp32"])
        if "grad_rel_rms_vs_fp32" in r:
            checks[f"{key}_grads"] = (r["grad_rel_rms_vs_fp32"],
                                      TP_FP32_RATIO
                                      * r["unsharded_grad_vs_fp32"])
        elif "grad_rel_rms" in r:
            checks[f"{key}_grads"] = (r["grad_rel_rms"], REL_RMS_BOUND)
        if "grad_rel_rms" in r:
            checks[f"{key}_loss"] = (abs(r["loss"] - r["loss_ref"])
                                     / abs(r["loss_ref"]), 1e-3)
        for flag in ("noise_bit_equal", "w8a8_rowpar_exact",
                     "miss_bit_equal", "replay_bit_equal",
                     "kernel_c_replayed"):
            if flag in r:
                checks[f"{key}_{flag}"] = (float(not r[flag]), 0.0)
    return {k: v for k, v in checks.items() if not v[0] <= v[1]}


def cut_config(depth: int):
    """The published widths at `depth` DiT layers and 2 layers in each
    encoder (blockwise=False, as training runs)."""
    return dataclasses.replace(base_dit_config(blockwise=False),
                               num_layers=depth, text_num_layers=2,
                               speaker_num_layers=2)


def state_tensors(state) -> list:
    """A train state's parameters, EMA and AdamW moments (its shards)."""
    mods = [state.model] + ([] if state.ema is None else [state.ema])
    out = [p.detach() for m in mods for p in m.parameters()]
    for p in state.model.parameters():
        moments = state.optimizer.state[p]
        out += [moments["exp_avg"], moments["exp_avg_sq"]]
    return out


STEP_EMA = 0.999       # the steps' EMA decay (make_train_step's default)


def _grad_distance(grads: dict, ref: dict, index=None) -> float:
    """rel-RMS of {name: gradient} against the matching blocks of `ref`
    ({name: the whole gradient}; `index` picks a rank's block of each)."""
    num = den = 0.0
    for name, g in grads.items():
        want = ref[name][index[name] if index else ()].float()
        num += float((g.float() - want).pow(2).sum())
        den += float(want.pow(2).sum())
    return (num / den) ** 0.5


def _mesh_step_check(model, refs: dict, loss_ref, mesh, make_state, call,
                     step, eager: bool) -> dict:
    """A train or distill step on the mesh (call(run, state) -> (state,
    loss), run the step or its .eager) from make_state(): its loss, and
    every gradient it applied (clipped) against the matching block of each
    whole-model reference of `refs` ({record key: {name: gradient} of
    `model`'s parameters}; "grad_rel_rms" is the one-card step's).
    eager=True runs the body alone, once.  Else the step runs twice
    through its program (the miss, then a replay) and twice through
    `step.eager` from an identical state: after each step, the loss,
    parameters, EMA and moments bit for bit (miss_bit_equal,
    replay_bit_equal), with the wall ms of each."""
    state = make_state()
    mark = profiling.now_ns()
    reset_launches()
    (_, loss), ms = wall_ms(lambda: call(step.eager if eager else step,
                                         state))
    ref = refs["grad_rel_rms"]
    specs = pmesh.dit_param_specs(model, pmesh.mesh_coords(mesh).tp)
    index = pmesh.to_named({n: specs[n] for n in ref}, mesh,
                           {n: g.shape for n, g in ref.items()})
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    out = dict(loss=float(loss), loss_ref=float(loss_ref), ms=ms,
               launches=launches(),
               **{key: _grad_distance(grads, r, index)
                  for key, r in refs.items()})
    if eager:
        return out
    twin = make_state()
    (_, want), eager_ms = wall_ms(lambda: call(step.eager, twin))
    out.update(miss_ms=ms, eager_ms=[eager_ms],
               miss_bit_equal=same(loss, want)
               and same(state_tensors(state), state_tensors(twin)))
    (_, loss), out["replay_ms"] = wall_ms(lambda: call(step, state))
    (_, want), eager_ms = wall_ms(lambda: call(step.eager, twin))
    out["eager_ms"].append(eager_ms)
    built = programs.builds(mark)
    out.update(replay_bit_equal=same(loss, want)
               and same(state_tensors(state), state_tensors(twin)),
               builds=len(built), build_s=sum(b.seconds for b in built),
               pool_bytes=programs.pool_bytes(loss.device))
    return out


def train_check(cfg, mesh, batch: dict, t: torch.Tensor, eps: torch.Tensor,
                device, eager: bool = False) -> dict:
    """One train step (remat "attn", an EMA) of a seeded DiT at `cfg` on
    the mesh against the one-card step on the same batch, t and eps
    (_mesh_step_check)."""
    model = tdit.init_dit(cfg, device=device, seed=1)
    tx = tstep.make_optimizer()
    single = tstep.create_train_state(model, tx)
    _, loss_ref = tstep.make_train_step(tx)(single, batch, t=t, eps=eps)
    ref = {n: p.grad for n, p in single.model.named_parameters()}
    del single
    return _mesh_step_check(
        model, {"grad_rel_rms": ref}, loss_ref, mesh,
        lambda: tstep.create_train_state(model, tx, ema=True, mesh=mesh),
        lambda run, state: run(state, batch, t=t, eps=eps),
        tstep.make_train_step(tx, ema_decay=STEP_EMA, mesh=mesh), eager)


def fp32_distill_grads(model, batch: dict, i: torch.Tensor,
                       eps: torch.Tensor, max_norm: float) -> dict:
    """{name: gradient} of one distill step (distill_loss's defaults) of
    an fp32 copy of `model`, its own teacher, plain attention, clipped as
    the step clips: what a bf16 step is held to.  The DiT's forward sees
    its timesteps rounded to bf16, as a bf16 step's embedding sees them
    (train_checks.py says why)."""
    student = tdit.trainable_copy(model).float()
    teacher = copy.deepcopy(model).float()
    forward = tdit.dit_forward_static

    def bf16_timesteps(m, x, t, *a, **k):
        return forward(m, x, t.to(torch.bfloat16).float(), *a, **k)

    tdit.dit_forward_static = bf16_timesteps
    try:
        with plain_kernels():
            tdistill.distill_loss(student, teacher, batch, i=i,
                                  eps=eps).backward()
    finally:
        tdit.dit_forward_static = forward
    grads = [p.grad for p in student.parameters()]
    tstep.clip_by_global_norm_(grads, torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads))), max_norm)
    return {n: p.grad for n, p in student.named_parameters()}


def distill_check(cfg, mesh, batch: dict, i: torch.Tensor, eps: torch.Tensor,
                  device, eager: bool = False) -> dict:
    """One distill step (distill_loss's defaults: 8 student steps, 5
    teacher substeps; an EMA) of a seeded DiT at `cfg`, its own teacher,
    on the mesh (the teacher sharded like the student) against the
    one-card step on the same batch, i and eps (_mesh_step_check), and
    each one's gradients against the fp32 step's (fp32_distill_grads):
    the loss is the mean square of the student's velocity less the
    teacher's, near each other, so each forward's bf16 rounding weighs
    more in the gradients than in a train step's."""
    model = tdit.init_dit(cfg, device=device, seed=1)
    tx = tstep.make_optimizer()
    single = tstep.create_train_state(model, tx)
    _, loss_ref = tdistill.make_distill_step(tx)(single, model, batch, i=i,
                                                 eps=eps)
    ref = {n: p.grad for n, p in single.model.named_parameters()}
    del single
    ref32 = fp32_distill_grads(model, batch, i, eps, tx.grad_clip)
    teacher = tdistill.shard_teacher(model, mesh)
    out = _mesh_step_check(
        model, {"grad_rel_rms": ref, "grad_rel_rms_vs_fp32": ref32},
        loss_ref, mesh,
        lambda: tstep.create_train_state(model, tx, ema=True, mesh=mesh),
        lambda run, state: run(state, teacher, batch, i=i, eps=eps),
        tdistill.make_distill_step(tx, ema_decay=STEP_EMA, mesh=mesh), eager)
    out["unsharded_grad_vs_fp32"] = _grad_distance(ref, ref32)
    return out


# ---------------------------------------------------------------------------
# Four cards over NCCL
# ---------------------------------------------------------------------------

RANK_LIMIT_S = 300     # a rank's seconds from its start (about 150 used)
TEARDOWN_S = 60        # seconds the ranks may take to end after the results


def _rank(rank: int, world: int, port: int, depth: int, out_path: str):
    """One card's checks, each printed as it ends, then its way out of the
    world, each step printed.  A rank that has not ended RANK_LIMIT_S
    seconds after it started prints every thread's stack and exits, and
    so does a rank sent SIGUSR1 (main): a hung collective, capture or
    teardown names its place and fails the run."""
    faulthandler.dump_traceback_later(RANK_LIMIT_S, exit=True)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    t0 = time.perf_counter()
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=RANK_LIMIT_S))
    res = {"world": world, "backend": dist.get_backend(), "depth": depth}

    def say(what):
        print(f"[{time.perf_counter() - t0:.1f} s] rank {rank} {what}",
              flush=True)

    def done(key):
        say(f"{key}: {json.dumps(res[key])}")

    cfg = base_dit_config()
    tp4 = pmesh.make_mesh(dp=1, tp=4)
    dp2tp2 = pmesh.make_mesh(dp=2, tp=2)
    req2 = request_inputs(dev, batch=2)
    req1 = {k: v[:1] for k, v in req2.items()}
    model = tdit.init_dit(cfg, device=dev, seed=0)
    res["collectives"] = collectives_check(tp4, model)
    done("collectives")
    # the one-card programs: B = 2, and B = 1 (its miss, then a replay),
    # bf16 and W8A8
    ref2, ref_ms = wall_ms(lambda: sample(model, req2))
    sample(model, req1)
    ref1, ref1_ms = wall_ms(lambda: sample(model, req1))
    lat32, fwd32 = fp32_refs(model, req2)
    w8a8 = quant.quantize_dit(copy.deepcopy(model))
    sample(w8a8, req1)
    ref_q1, ref_q1_ms = wall_ms(lambda: sample(w8a8, req1))
    # sharding in place frees the weights the one-card programs read
    programs.clear_all()
    res["tp4"] = tp_forward_check(model, tp4, req2, fwd32, w8a8=w8a8)
    done("tp4")
    # row 0 of the B = 2 fp32 pass is the B = 1 request's
    res["tp4_sample"] = dp_sample_check(model, tp4, req1, ref1, lat32[:1])
    res["tp4_sample"]["unsharded_ms"] = ref1_ms
    done("tp4_sample")
    res["tp4_w8a8_sample"] = w8a8_sample_check(w8a8, tp4, req1, ref_q1,
                                               lat32[:1])
    res["tp4_w8a8_sample"]["unsharded_ms"] = ref_q1_ms
    done("tp4_w8a8_sample")
    del model, w8a8
    programs.purge()
    torch.cuda.empty_cache()
    model = pmesh.shard_params(tdit.init_dit(cfg, device=dev, seed=0), dp2tp2)
    res["dp2tp2_sample"] = dp_sample_check(model, dp2tp2, req2, ref2, lat32)
    res["dp2tp2_sample"]["unsharded_ms"] = ref_ms
    done("dp2tp2_sample")
    del model
    programs.purge()
    torch.cuda.empty_cache()
    from .train_checks import train_batch
    g = torch.Generator(device=dev).manual_seed(61)
    batch = train_batch(cut_config(depth), 60, dev)
    t = torch.rand((2,), generator=g, device=dev)
    eps = torch.randn((2, 640, 80), generator=g, device=dev)
    i = torch.randint(0, tdistill.NUM_STUDENT_STEPS, (2,), generator=g,
                      device=dev)
    res["dp2tp2_train"] = train_check(cut_config(depth), dp2tp2, batch, t,
                                      eps, dev)
    done("dp2tp2_train")
    programs.purge()
    torch.cuda.empty_cache()
    res["dp2tp2_distill"] = distill_check(cut_config(depth), dp2tp2, batch,
                                          i, eps, dev)
    done("dp2tp2_distill")
    programs.purge()
    torch.cuda.empty_cache()
    res["sp4"] = sp_check(tdit.init_dit(cfg, device=dev, seed=0), tp4)
    done("sp4")
    results = [None] * world
    dist.all_gather_object(results, res)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)
    say("results gathered")
    pdist.shutdown()
    say("left the world (parallel.distributed.shutdown)")


TIMED = ("sp4", "tp4_sample", "tp4_w8a8_sample", "dp2tp2_sample",
         "dp2tp2_train", "dp2tp2_distill")


def times_line(rank: int, res: dict) -> str:
    """One rank's host-clock wall ms, eager against replayed, and its
    program builds, for print."""
    parts = []
    for key in TIMED:
        r = res[key]
        parts.append(
            f"{key} eager {_ms(r['eager_ms'])} miss {r['miss_ms']:.1f} "
            f"replayed {_ms(r['replay_ms'])} ({r['builds']} builds, "
            f"{r['build_s']:.2f} s)")
    return (f"rank {rank}: " + "; ".join(parts) + f"; pool "
            f"{res['dp2tp2_distill']['pool_bytes'] / 2**30:.2f} GiB after")


def _ms(v) -> str:
    return "/".join(f"{x:.1f}" for x in (v if isinstance(v, list) else [v]))


def _join(ctx, out_path: str, t0: float) -> dict:
    """Wait for the ranks (main): until each has ended, RANK_LIMIT_S after
    the start, or TEARDOWN_S after rank 0 wrote the results.  A rank still
    alive then prints its stacks (SIGUSR1) and is ended.  Returns
    {"ranks_alive": [...]} or {"spawn": error} for what went wrong, else
    {}."""
    results_at = None
    while True:
        try:
            if ctx.join(timeout=1.0):
                return {}
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            return {"spawn": str(e)}
        now = time.perf_counter()
        if results_at is None and os.path.exists(out_path):
            results_at = now
        if now - t0 > RANK_LIMIT_S + 10 or (
                results_at is not None and now - results_at > TEARDOWN_S):
            break
    alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
    print(f"[{time.perf_counter() - t0:.1f} s] ranks {alive} still alive "
          f"{'after the results' if results_at else 'before the results'}; "
          "their stacks follow", flush=True)
    for r in alive:
        os.kill(ctx.processes[r].pid, signal.SIGUSR1)
    time.sleep(5)
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
        p.join()
    return {"ranks_alive": alive}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=4,
                    help="DiT layers of the train step's model")
    args = ap.parse_args(argv)
    world = torch.cuda.device_count()
    if world < 4:
        raise SystemExit(f"parallel_checks needs 4 cards, found {world}")
    world = 4
    smi = card_names()
    for line in smi:
        print(line, flush=True)
    from ..ops import cuda_build
    cuda_build.build()          # once, before the ranks load the libraries
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "ranks.json")
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(
            _rank, args=(world, port, args.depth, out_path), nprocs=world,
            join=False, start_method="spawn")
        ended = _join(ctx, out_path, t0)
        ranks = []
        if os.path.exists(out_path):
            with open(out_path) as f:
                ranks = json.load(f)
    for r, res in enumerate(ranks):
        print(times_line(r, res), flush=True)
    failed = {r: f for r, f in enumerate(map(failures, ranks)) if f}
    if ended or not ranks:
        failed["run"] = ended or {"results": "rank 0 wrote none"}
    print(json.dumps({"cards": smi, "seconds": time.perf_counter() - t0,
                      "failed": failed, "ranks": ranks}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
