"""The published DiT at full depth and width: one CFG-batched forward in
bf16 with kernel A against the same weights in fp32.  Counterpart of
tools/check_fullsize_onchip.py.

The DiT of base_dit_config (24/14/14 layers, 2.80 B parameters) with
seeded random bf16 weights runs one CFG forward (GB = 3: cond, no text, no
speaker; S = 640 at t = 0.7, over the prefill of a 768-byte prompt and a
640-latent speaker: parallel_checks.cfg_forward) twice:

  * in bf16 with kernel A, the serving setting;
  * in fp32, a copy of the same weights, with the plain attention and TF32
    off: the oracle.  The card runs neither JAX nor the reference, so the
    oracle is the port's own fp32 run.

Gate: the JAX script's envelope (check_fullsize_onchip.py:52-53), rel-RMS
(the error's RMS over the fp32 output's standard deviation) < 0.05 and
max-abs < 0.30.  Beside it, as the JAX script does, the W8A8 DiT's forward
(kernel C) from bf16 and from fp32: information only, but it must be
finite and within rel-RMS 0.15 of bf16, or the quantized DiT broke.

    python -m echo_tts_torch.tools.check_fullsize [--seed 0]

Prints the card's name and power limit, then one JSON line; exits 1 when a
gate fails.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch

from ..config import base_dit_config
from ..device import card_name
from ..models.dit import init_dit, plain_attention
from ..ops.quant import quantize_dit
from . import parallel_checks as pc
from .stream_checks import no_tf32

ENVELOPE_REL_RMS = 0.05
ENVELOPE_MAX_ABS = 0.30
W8A8_REL_RMS_BOUND = 0.15


def _distance(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max-abs, rel-RMS over ref's standard deviation), the JAX script's
    measures."""
    err = got.float() - ref.float()
    return (float(err.abs().max()),
            float(err.pow(2).mean().sqrt() / ref.float().std()))


def check(dit, seed: int = 7) -> dict:
    """The three forwards of `dit` (bf16) on request_inputs(seed); returns
    the report with its `failures` (empty when every gate holds)."""
    t0 = time.perf_counter()
    req = pc.request_inputs(next(dit.parameters()).device, seed=seed)
    pc.reset_launches()
    with no_tf32():
        bf16 = pc.cfg_forward(dit, req)
        fp32 = copy.deepcopy(dit).float()
        with plain_attention():
            ref = pc.cfg_forward(fp32, req)
        del fp32
        w8a8 = pc.cfg_forward(quantize_dit(dit), req)
    max_abs, rel = _distance(bf16, ref)
    q_max_abs, q_rel = _distance(w8a8, bf16)
    report = {
        "metric": "fullsize_forward", "shape": list(bf16.shape),
        "dtype": str(bf16.dtype).removeprefix("torch."),
        "out_std": float(ref.std()), "max_abs_err": max_abs,
        "rel_rms_err": rel, "envelope_rel_rms": ENVELOPE_REL_RMS,
        "envelope_max_abs": ENVELOPE_MAX_ABS,
        "int8_rel_rms_vs_bf16": q_rel, "int8_max_abs_vs_bf16": q_max_abs,
        "int8_rel_rms_vs_fp32": _distance(w8a8, ref)[1],
        "launches": pc.launches(), "wall_s": time.perf_counter() - t0,
    }
    failures = []
    if not bool(bf16.isfinite().all()) or bf16.dtype != torch.float32:
        failures.append(f"bf16 forward: dtype {bf16.dtype} or non-finite")
    if not rel < ENVELOPE_REL_RMS:
        failures.append(f"rel-RMS {rel:.4e} >= {ENVELOPE_REL_RMS}")
    if not max_abs < ENVELOPE_MAX_ABS:
        failures.append(f"max-abs {max_abs:.4e} >= {ENVELOPE_MAX_ABS}")
    if not (bool(w8a8.isfinite().all()) and q_rel < W8A8_REL_RMS_BOUND):
        failures.append(f"W8A8 forward: rel-RMS from bf16 {q_rel:.4e} "
                        f"(bound {W8A8_REL_RMS_BOUND}) or non-finite")
    report["failures"] = failures
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="weights' seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: ECHO_DEVICE, else cuda)")
    args = ap.parse_args(argv)
    dit = init_dit(base_dit_config(), seed=args.seed,
                   device=args.device or os.environ.get("ECHO_DEVICE", "cuda"))
    print(card_name(next(dit.parameters()).device), flush=True)
    report = check(dit)
    print(json.dumps(report), flush=True)
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
