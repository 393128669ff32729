"""Training compute on one card: the full-size value-and-grad step (the
flow-matching loss, train/step.py flow_matching_loss, and its backward
through the 24-layer DiT with per-layer remat).  Counterpart of
examples/bench_train_step.py.

The scope is the value-and-grad step, not the optimizer: the compute
throughput of a training step is a one-card property, while the AdamW
moments of the published size need their own memory (the whole step is
train/step.py make_train_step, which chip_smoke.py request (i) times).
bf16 parameters, fp32 loss; the gradients are taken with
torch.autograd.grad and summed into a scalar, so that one set of
gradients lives at a time.  The step is one program of GRAD_PROGRAMS
(utils/programs.py) per remat mode, attention policy and batch shape, as
the JAX script jits it: a CUDA graph on a card, t and eps drawn before
it; the first call at a point runs eagerly and captures, later ones
replay, so a timed call comes after at least one --warmup.

Single run (one JSON line):

    python -m echo_tts_torch.examples.bench_train_step
      ECHO_BENCH_TRAIN_B (default 2), ECHO_BENCH_TRAIN_REMAT
      (full|dots|dots_all|attn|none, default full), ECHO_BENCH_TRAIN_ATTN
      (kernel|plain, default kernel: kernel A, whose backward recomputes
      through the plain version; plain: the plain version throughout)

Policy sweep (one JSON line, {"sweep": rows}):

    python -m echo_tts_torch.examples.bench_train_step --sweep \
        [--remats attn,full] [--attn kernel,plain] [--b-start 2] [--b-max 64]

  For each (remat, attention) policy B doubles until the card runs out
  of memory, in the eager run or in the capture after it: that point is
  recorded with step_ms None, the step's tensors and programs are freed
  (gc, torch.cuda.empty_cache, the peak counter reset) and the next policy
  starts.  Only torch.cuda.OutOfMemoryError is caught.  The largest B
  that ran is marked hbm_max_for_policy.

A row: step_ms (median of --reps), tokens_per_s (B x 640 latents a step),
useful_tflops_rate (3 x the forward's useful FLOPs, useful_fwd_tflop, a
step), mfu_vs_bf16_peak (against 989 TFLOP/s, the card's dense bf16
peak), launches_per_step (kernel A), peak_memory_mb
(torch.cuda.max_memory_allocated over the point).
"""
from __future__ import annotations

import contextlib
import functools
import gc
import math
import os
import sys

import torch

from ..models import dit
from ..models.plain import plain_kernels
from ..ops.joint_attention import fused_joint_attention
from ..train.step import attention_route, draw_noise, flow_matching_loss
from ..utils import programs
from ..utils.profiling import PEAK_BF16_FLOPS
from . import stages

SEQ, TEXT_LEN, SPK_LEN = 640, 768, 640
TINY_SEQ, TINY_TEXT_LEN, TINY_SPK_LEN = 16, 32, 16
REMATS = ("full", "dots", "dots_all", "attn", "none")
ATTNS = ("kernel", "plain")


def useful_fwd_tflop(cfg, b: int, seq: int = SEQ, text_len: int = TEXT_LEN,
                     spk_len: int = SPK_LEN) -> float:
    """The forward's useful TFLOP at batch b: the trunk's weight products
    and its attention over [self | text | speaker] columns, and the text
    and speaker encoders (the JAX script's count, _useful_fwd_tflop)."""
    per_layer_w = (5 * cfg.model_size ** 2
                   + 3 * cfg.model_size * cfg.intermediate_size)
    t_total = seq + text_len + spk_len // cfg.speaker_patch_size
    trunk_macs = cfg.num_layers * (per_layer_w + 2 * t_total * cfg.model_size)
    trunk = trunk_macs * b * seq

    def enc(tokens, d, f, n_layers):
        per_layer = 5 * d * d + 3 * d * f + tokens * d
        return n_layers * per_layer * tokens

    encoders = b * (
        enc(text_len, cfg.text_model_size, cfg.text_intermediate_size,
            cfg.text_num_layers)
        + enc(spk_len // cfg.speaker_patch_size, cfg.speaker_model_size,
              cfg.speaker_intermediate_size, cfg.speaker_num_layers))
    return 2 * (trunk + encoders) / 1e12


def make_batch(cfg, b: int, lengths, device) -> dict:
    g = torch.Generator().manual_seed(1)
    seq, text_len, spk_len = lengths
    batch = dict(
        latents=torch.randn((b, seq, cfg.latent_size), generator=g),
        text_ids=torch.randint(0, 256, (b, text_len), generator=g,
                               dtype=torch.int32),
        text_mask=torch.ones((b, text_len), dtype=torch.bool),
        speaker_latent=torch.randn((b, spk_len, cfg.latent_size), generator=g),
        speaker_mask=torch.ones((b, spk_len), dtype=torch.bool))
    return {k: v.to(device) for k, v in batch.items()}


# One program per (remat, attention route), model and batch shapes (the
# JAX script's jitted value-and-grad step, examples/bench_train_step.py:89)
GRAD_PROGRAMS = programs.ProgramCache("grad_step", 8)


def _grad_body(model, batch: dict, t, eps, *, remat: str):
    params = [p for p in model.parameters() if p.requires_grad]
    loss = flow_matching_loss(model, batch, t=t, eps=eps, remat=remat)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), sum(g.float().sum() for g in grads if g is not None)


def grad_step(model, batch: dict, generator, remat: str):
    """The loss and the sum of every gradient (a scalar each): t and eps
    drawn from generator, then one program of GRAD_PROGRAMS."""
    t, eps = draw_noise(batch["latents"], generator)
    return GRAD_PROGRAMS((remat, attention_route()), model, (batch, t, eps),
                         lambda: functools.partial(_grad_body, remat=remat))


def attention(attn: str):
    """The DiT's joint attention as the policy asks: kernel A (its
    backward a plain recompute), or the plain version throughout."""
    if attn == "kernel":
        return contextlib.nullcontext()
    return plain_kernels()


def free(device) -> None:
    GRAD_PROGRAMS.clear()         # a point's graph and its pool memory
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def measure(model, b: int, remat: str, attn: str, lengths, args):
    """A row at batch b, or None when the card runs out of memory."""
    device = next(model.parameters()).device
    free(device)
    try:
        batch = make_batch(model.cfg, b, lengths, device)
        gen = torch.Generator(device=device).manual_seed(7)
        with attention(attn):
            before = fused_joint_attention.launches
            out, runs = stages.timed_stage(
                lambda: grad_step(model, batch, gen, remat), args)
            calls = args.warmup + args.reps
            launches = (fused_joint_attention.launches - before) / calls
    except torch.cuda.OutOfMemoryError:
        return None
    loss, gsum = (float(x) for x in out)
    step_s = stages.median(runs) / 1e3
    tflops = 3 * useful_fwd_tflop(model.cfg, b, *lengths) / step_s
    return {
        "remat": remat, "attn": attn, "batch": b,
        "step_ms": step_s * 1e3,
        "tokens_per_s": b * lengths[0] / step_s,
        "useful_tflops_rate": tflops,
        "mfu_vs_bf16_peak": tflops * 1e12 / PEAK_BF16_FLOPS,
        "launches_per_step": launches,
        "peak_memory_mb": (torch.cuda.max_memory_allocated(device) / 2**20
                           if device.type == "cuda" else None),
        "loss": loss, "grad_sum_finite": math.isfinite(gsum),
        "ranges": {"step_ms": stages.span(runs)},
    }


def point(model, b, remat, attn, lengths, args) -> dict:
    row = measure(model, b, remat, attn, lengths, args)
    free(next(model.parameters()).device)
    return row or {"remat": remat, "attn": attn, "batch": b, "oom": True,
                   "step_ms": None}


def sweep(model, attns, remats, b_start: int, b_max: int, lengths, args
          ) -> list:
    """Per policy: B doubles from b_start to b_max until out of memory."""
    rows = []
    for attn in attns:
        for remat in remats:
            b, best = b_start, None
            while b <= b_max:
                row = point(model, b, remat, attn, lengths, args)
                rows.append(row)
                print(row, file=sys.stderr, flush=True)
                if row.get("oom"):
                    break
                best = row
                b *= 2
            if best is not None:
                best["hbm_max_for_policy"] = True
    return rows


def _choices(ap, text: str, allowed, what: str) -> list:
    got = [x for x in text.split(",") if x]
    bad = [x for x in got if x not in allowed]
    if bad or not got:
        ap.error(f"{what} {got}: choose from {allowed}")
    return got


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--remats", default=",".join(REMATS),
                    help="comma list of remat modes to sweep")
    ap.add_argument("--attn", default="kernel",
                    help="comma list of attention policies (kernel, plain)")
    ap.add_argument("--b-start", type=int, default=2)
    ap.add_argument("--b-max", type=int, default=64)
    given = models is not None
    args, models, _ = stages.setup(ap, argv, models, blockwise=False)
    lengths = ((TINY_SEQ, TINY_TEXT_LEN, TINY_SPK_LEN) if args.tiny
               else (SEQ, TEXT_LEN, SPK_LEN))
    # a caller's DiT stays frozen; one built here trains in place
    model = (dit.trainable_copy(models.dit) if given
             else models.dit.requires_grad_(True))
    if args.sweep:
        rows = sweep(model, _choices(ap, args.attn, ATTNS, "--attn"),
                     _choices(ap, args.remats, REMATS, "--remats"),
                     args.b_start, args.b_max, lengths, args)
        return stages.emit({"sweep": rows}, models.device)

    b = int(os.environ.get("ECHO_BENCH_TRAIN_B", "2"))
    remat = os.environ.get("ECHO_BENCH_TRAIN_REMAT", "full")
    attn = os.environ.get("ECHO_BENCH_TRAIN_ATTN", "kernel")
    _choices(ap, remat, REMATS, "ECHO_BENCH_TRAIN_REMAT")
    _choices(ap, attn, ATTNS, "ECHO_BENCH_TRAIN_ATTN")
    row = point(model, b, remat, attn, lengths, args)
    if row.get("oom"):
        return stages.emit({"metric": "train_grad_step_fullsize", **row},
                           models.device)
    return stages.emit({
        "metric": "train_grad_step_fullsize", "value": row["step_ms"],
        "unit": "ms", "seq": lengths[0], **row,
        "note": "MFU = the forward and backward's useful FLOPs only (remat "
                "re-forwards are overhead); the optimizer is not timed"},
        models.device)


if __name__ == "__main__":
    sys.exit(main())
