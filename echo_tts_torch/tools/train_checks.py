"""How far one bf16 training step's gradients sit from the fp32 step's, at
full width on one CUDA card.

    python -m echo_tts_torch.tools.train_checks [--seeds 0,1,2,3] \
        [--depths 1,4,12]

The published DiT (blockwise=False) with seeded random weights, at B = 2
on one batch of the DataConfig shapes (`train_batch`; seed 0 draws
chip_smoke.py's request (i) batch, t and eps).  For every seed at the
full 24 layers, and for seed 0 cut to each of `--depths` layers, one
step's gradients (flow_matching_loss, remat "none") as rel-RMS distances
over all parameters together:

  kernel_vs_plain  the bf16 step with kernel A against the same step with
                   joint_attention_plain;
  kernel_vs_fp32   the bf16 step with kernel A against the fp32 step
                   (plain attention, TF32 off) at the timestep the bf16
                   step sees: t rounded to bf16;
  plain_vs_fp32    the bf16 step with joint_attention_plain against that
                   fp32 step;
  fp32_exact_t     the fp32 step at the unrounded t against the fp32 step
                   at the rounded t.  The timestep embedding's frequencies
                   reach 1000 per unit t, so t's rounding to bf16 (relative
                   2^-9) turns its highest components by up to a radian:
                   this distance is the bf16 step's different input, not
                   its arithmetic.

chip_smoke.py's request (i) holds kernel_vs_fp32 to GRAD_FP32_RATIO times
plain_vs_fp32.  The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import torch

from ..config import base_dit_config
from ..device import card_name
from ..models import dit as tdit
from ..ops.joint_attention import joint_attention_plain
from ..pipeline.text import get_text_input_ids_and_mask
from ..train import step as tstep

TRAIN_TEXTS = ("The quick brown fox jumps over the lazy dog, then reads it "
               "a bedtime story.",
               "Good morning, and welcome to the station.")
SPEAKER_COLUMNS = (640, 300)  # valid speaker latents of the two rows


def train_batch(cfg, seed: int, device="cuda") -> dict:
    """One batch of the DataConfig shapes at B = 2: 640 target latents
    (row 1's window ends at 500, the rest padding), 768 text bytes of
    TRAIN_TEXTS, 640 speaker latents (the second row's valid up to
    300)."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids, tmask = get_text_input_ids_and_mask(list(TRAIN_TEXTS), 768)
    latent_mask = torch.ones((2, 640), dtype=torch.bool, device=device)
    latent_mask[1, 500:] = False
    speaker_mask = torch.zeros((2, 640), dtype=torch.bool, device=device)
    for i, n in enumerate(SPEAKER_COLUMNS):
        speaker_mask[i, :n] = True
    return {"latents": torch.randn((2, 640, cfg.latent_size), generator=g,
                                   device=device) * latent_mask[..., None],
            "latent_mask": latent_mask,
            "text_ids": torch.from_numpy(ids).to(device),
            "text_mask": torch.from_numpy(tmask).to(device),
            "speaker_latent": torch.randn((2, 640, cfg.latent_size),
                                          generator=g, device=device),
            "speaker_mask": speaker_mask}


def train_draws(cfg, seed: int, device="cuda"):
    """(batch, t, eps) for `seed`: seed 0 is request (i)'s batch (seed
    60) and draws (seed 61)."""
    batch = train_batch(cfg, 60 + 10 * seed, device)
    g = torch.Generator(device=device).manual_seed(61 + 10 * seed)
    t = torch.rand((2,), generator=g, device=device)
    eps = torch.randn((2, 640, cfg.latent_size), generator=g, device=device)
    return batch, t, eps


def grad_rel_rms(got, want) -> float:
    """sqrt(sum |got - want|^2 / sum |want|^2) over every parameter's
    gradient, accumulated in fp32."""
    num = den = 0.0
    for a, b in zip(got, want):
        d = a.float() - b.float()
        num += float((d * d).sum())
        den += float(b.float().pow(2).sum())
    return math.sqrt(num / den)


def step_grads(model, batch, t, eps, dtype=torch.bfloat16, *,
               plain: bool = False, remat: str = "none"):
    """(loss, every parameter's gradient) of one flow_matching_loss step
    on a trainable copy of `model` cast to `dtype`; plain=True puts
    joint_attention_plain in kernel A's place."""
    trained = tdit.trainable_copy(model).to(dtype)
    attention = tdit.fused_joint_attention
    if plain:
        tdit.fused_joint_attention = joint_attention_plain
    try:
        loss = tstep.flow_matching_loss(trained, batch, t=t, eps=eps,
                                        remat=remat)
        loss.backward()
    finally:
        tdit.fused_joint_attention = attention
    grads = [p.grad for p in trained.parameters()]
    if any(x is None for x in grads):
        raise AssertionError("a parameter got no gradient")
    return float(loss.detach()), grads


def precision_gaps(model, batch, t, eps, kernel_grads=None, *,
                   exact_t: bool = True) -> dict:
    """The module docstring's distances for one step; kernel_grads, the
    bf16 step's with kernel A, are computed unless given.  Only the plain
    version runs here otherwise."""
    if kernel_grads is None:
        _, kernel_grads = step_grads(model, batch, t, eps)
    _, plain = step_grads(model, batch, t, eps, plain=True)
    t16 = t.to(torch.bfloat16).float()
    _, fp32 = step_grads(model, batch, t16, eps, torch.float32, plain=True)
    out = dict(kernel_vs_plain=grad_rel_rms(kernel_grads, plain),
               kernel_vs_fp32=grad_rel_rms(kernel_grads, fp32),
               plain_vs_fp32=grad_rel_rms(plain, fp32))
    out["ratio"] = out["kernel_vs_fp32"] / out["plain_vs_fp32"]
    del plain
    if exact_t:
        _, exact = step_grads(model, batch, t, eps, torch.float32, plain=True)
        out["fp32_exact_t"] = grad_rel_rms(exact, fp32)
    return out


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--depths", default="1,4,12")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_checks needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    print(card, flush=True)
    base = base_dit_config(blockwise=False)
    runs = [(0, n) for n in _ints(args.depths)]
    runs += [(s, base.num_layers) for s in _ints(args.seeds)]
    rows = []
    for seed, layers in runs:
        model = tdit.init_dit(dataclasses.replace(base, num_layers=layers),
                              seed=seed)
        batch, t, eps = train_draws(model.cfg, seed)
        gaps = precision_gaps(model, batch, t, eps)
        del model
        torch.cuda.empty_cache()
        rows.append(dict(seed=seed, layers=layers, t=t.tolist(), **gaps))
        print(f"seed {seed} layers {layers}: " + ", ".join(
            f"{k} {v:.4e}" for k, v in gaps.items()), flush=True)
    print(json.dumps(dict(card=card, runs=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
