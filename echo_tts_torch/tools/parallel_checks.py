"""Tensor-, data- and sequence-parallel runs at full width against the
unsharded ones, over the cards of one host.

    python -m echo_tts_torch.tools.parallel_checks [--depth 4]

One process per card (torch.multiprocessing spawn), joined over NCCL on
localhost; needs four cards.  Every rank builds the published DiT from
seed 0 (seeded random bf16 weights; init_dit is deterministic), computes
its unsharded references on its own card, then shards and compares:

  tp4        one CFG forward (GB = 3, S = 640) at tp = 4: the 10-head
             text and speaker encoders run replicated, the DiT at 4 of its
             16 heads a rank; bf16 and the W8A8 DiT (row-parallel products
             through kernel C's given-scale instance), each against its
             unsharded forward;
  sp4        the 6400-latent speaker prefill split four ways over the
             patch axis against get_kv_cache_speaker;
  dp2tp2     a B = 2 request, 40 Euler steps, on a dp2 x tp2 mesh against
             the unsharded B = 2 pass: each rank's row, the noise rows bit
             for bit; and one train step of the DiT cut to --depth layers
             (encoders 2) at B = 2 against the one-card step.

chip_smoke.py's request (o) runs the same functions with two ranks on one
card over gloo.  Distances are rel-RMS; times are host-clock wall
milliseconds between synchronises.  Rank 0 prints the card's name and
power limit and, as its last line, one JSON object with every number.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

from ..config import SAMPLER_DEFAULTS, base_dit_config
from ..device import card_names
from ..models import dit as tdit
from ..ops import quant
from ..ops.int8_matmul import int8_matmul_fused, int8_matmul_partial
from ..ops.joint_attention import fused_joint_attention, joint_attention_plain
from ..parallel import inference as pinf
from ..parallel import mesh as pmesh
from ..parallel.sp import get_kv_cache_speaker_sp
from ..pipeline.text import get_text_input_ids_and_mask
from ..sampler.euler import (make_cfg_branch_masks,
                             sample_euler_cfg_independent_guidances)
from ..train import step as tstep

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


def sample(model, req: dict, mesh=None) -> torch.Tensor:
    """The request's 40-step latents through the serving sampler (the
    rank's rows under a mesh)."""
    spk, smask, ids, tmask, noise = (req[k] for k in ("spk", "smask", "ids",
                                                      "tmask", "noise"))
    if mesh is not None:
        spk, smask, ids, tmask, noise = pinf.place_request(
            mesh, spk, smask, ids, tmask, noise)
    kw = dict(SAMPLER_DEFAULTS)
    kw.pop("sequence_length")
    return sample_euler_cfg_independent_guidances(
        model, spk, smask, ids, tmask, initial_noise=noise, mesh=mesh,
        dtype=next(model.parameters()).dtype,
        sequence_length=noise.shape[1], **kw)


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


def tp_forward_check(model, mesh, req: dict, fp32_ref=None) -> dict:
    """bf16 and W8A8 CFG forwards at the mesh's tp against the unsharded
    ones, and, given the fp32 forward `fp32_ref`, each one's distance from
    it beside the unsharded one's; and `rowpar_w8a8_exact`.  `model`
    (whole) is sharded in place; the W8A8 model is a quantized copy of
    it, made whole and then sharded."""
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


def sp_check(model, mesh, seed: int = 8) -> dict:
    """The SP_LATENTS speaker prefill split over the model axis against
    get_kv_cache_speaker on the whole model."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    lat = torch.randn((1, SP_LATENTS, 80), generator=g,
                      device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        (ref_k, ref_v), ref_ms = wall_ms(
            lambda: tdit.get_kv_cache_speaker(model, lat))
    (k, v), ms = wall_ms(lambda: get_kv_cache_speaker_sp(model, lat, mesh))
    return dict(k_rel_rms=rel_rms(k, ref_k), v_rel_rms=rel_rms(v, ref_v),
                ms=ms, unsharded_ms=ref_ms)


def dp_sample_check(model, mesh, req: dict, ref: torch.Tensor,
                    fp32_ref=None) -> dict:
    """The request's rows of the rank's data coordinate against the
    unsharded pass `ref` (B, 640, 80), and, given the fp32 pass
    `fp32_ref`, each one's distance from it; its noise rows bit for
    bit."""
    rows = pmesh.batch_spec(mesh, req["noise"].shape[0])
    noise = pinf.place_request(mesh, req["spk"], req["smask"], req["ids"],
                               req["tmask"], req["noise"])[-1]
    reset_launches()
    got, ms = wall_ms(lambda: sample(model, req, mesh))
    out = dict(rel_rms=rel_rms(got, ref[rows]), ms=ms, launches=launches(),
               rows=[rows.start, rows.stop],
               noise_bit_equal=bool(torch.equal(noise, req["noise"][rows])))
    if fp32_ref is not None:
        out.update(rel_rms_vs_fp32=rel_rms(got, fp32_ref[rows]),
                   unsharded_vs_fp32=rel_rms(ref[rows], fp32_ref[rows]))
    return out


@contextlib.contextmanager
def plain_attention():
    """The DiT's joint attention through its plain version (fp32 models:
    kernel A takes bf16 only); nothing launches kernel A inside."""
    attention = tdit.fused_joint_attention
    tdit.fused_joint_attention = joint_attention_plain
    try:
        yield
    finally:
        tdit.fused_joint_attention = attention


@torch.inference_mode()
def fp32_refs(model, req: dict) -> tuple:
    """The fp32 copy of `model` (plain attention): its 40-step latents on
    `req` and its CFG forward."""
    fp32 = copy.deepcopy(model).float()
    with plain_attention():
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
        if "grad_rel_rms" in r:
            checks[f"{key}_grads"] = (r["grad_rel_rms"], REL_RMS_BOUND)
            checks[f"{key}_loss"] = (abs(r["loss"] - r["loss_ref"])
                                     / abs(r["loss_ref"]), 1e-3)
        for flag in ("noise_bit_equal", "w8a8_rowpar_exact"):
            if flag in r:
                checks[f"{key}_{flag}"] = (float(not r[flag]), 0.0)
    return {k: v for k, v in checks.items() if not v[0] <= v[1]}


def cut_config(depth: int):
    """The published widths at `depth` DiT layers and 2 layers in each
    encoder (blockwise=False, as training runs)."""
    return dataclasses.replace(base_dit_config(blockwise=False),
                               num_layers=depth, text_num_layers=2,
                               speaker_num_layers=2)


def train_check(cfg, mesh, batch: dict, t: torch.Tensor, eps: torch.Tensor,
                device) -> dict:
    """One train step (remat "attn") of a seeded DiT at `cfg` on the mesh
    against the one-card step on the same batch, t and eps: the loss, and
    every gradient the step applied (clipped) against the matching block
    of the one-card step's."""
    model = tdit.init_dit(cfg, device=device, seed=1)
    tx = tstep.make_optimizer()
    single = tstep.create_train_state(model, tx)
    _, loss_ref = tstep.make_train_step(tx)(single, batch, t=t, eps=eps)
    ref = {n: p.grad for n, p in single.model.named_parameters()}
    state = tstep.create_train_state(model, tx, mesh=mesh)
    reset_launches()
    (_, loss), ms = wall_ms(lambda: tstep.make_train_step(tx, mesh=mesh)(
        state, batch, t=t, eps=eps))
    specs = pmesh.dit_param_specs(model, pmesh.mesh_coords(mesh).tp)
    index = pmesh.to_named({n: specs[n] for n in ref}, mesh,
                           {n: g.shape for n, g in ref.items()})
    num = den = 0.0
    for n, p in state.model.named_parameters():
        want = ref[n][index[n]].float()
        num += float((p.grad.float() - want).pow(2).sum())
        den += float(want.pow(2).sum())
    return dict(loss=float(loss), loss_ref=float(loss_ref),
                grad_rel_rms=(num / den) ** 0.5, ms=ms, launches=launches())


# ---------------------------------------------------------------------------
# Four cards over NCCL
# ---------------------------------------------------------------------------

def _rank(rank: int, world: int, port: int, depth: int, out_path: str):
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    res = {"world": world, "backend": dist.get_backend(), "depth": depth}
    cfg = base_dit_config()
    tp4 = pmesh.make_mesh(dp=1, tp=4)
    dp2tp2 = pmesh.make_mesh(dp=2, tp=2)
    req2 = request_inputs(dev, batch=2)
    model = tdit.init_dit(cfg, device=dev, seed=0)
    res["sp4"] = sp_check(model, tp4)
    ref2, ref_ms = wall_ms(lambda: sample(model, req2))
    lat32, fwd32 = fp32_refs(model, req2)
    res["tp4"] = tp_forward_check(model, tp4, req2, fwd32)
    del model
    torch.cuda.empty_cache()
    model = pmesh.shard_params(tdit.init_dit(cfg, device=dev, seed=0), dp2tp2)
    res["dp2tp2_sample"] = dp_sample_check(model, dp2tp2, req2, ref2, lat32)
    res["dp2tp2_sample"]["unsharded_ms"] = ref_ms
    del model
    torch.cuda.empty_cache()
    from .train_checks import train_batch
    g = torch.Generator(device=dev).manual_seed(61)
    batch = train_batch(cut_config(depth), 60, dev)
    t = torch.rand((2,), generator=g, device=dev)
    eps = torch.randn((2, 640, 80), generator=g, device=dev)
    res["dp2tp2_train"] = train_check(cut_config(depth), dp2tp2, batch, t,
                                      eps, dev)
    results = [None] * world
    dist.all_gather_object(results, res)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


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
        torch.multiprocessing.spawn(_rank, args=(world, port, args.depth,
                                                 out_path), nprocs=world)
        with open(out_path) as f:
            ranks = json.load(f)
    failed = {r: f for r, f in enumerate(map(failures, ranks)) if f}
    print(json.dumps({"cards": smi, "seconds": time.perf_counter() - t0,
                      "failed": failed, "ranks": ranks}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
