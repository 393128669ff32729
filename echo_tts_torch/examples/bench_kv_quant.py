"""Accept or reject int8 static K/V on the card: the 40-step sampler with
bf16 and with int8 static K/V (ops.quant.quantize_kv_int8).  Counterpart
of examples/bench_kv_quant.py.

The prefilled text + speaker K/V is constant over a request and read by
all 24 layers on each of the 40 steps.  Int8 storage halves its memory
and its read bytes; kernel A folds the per-token scales into its column
scales and converts each static tile after the load, so no bf16 copy is
made.  Rows:

  * B = 1, 640-latent speaker (T = 768 + 160 static columns);
  * B = 8 (--skip-b8 leaves it out) over the 640-latent speaker, or with
    --long-speaker the 6400-latent bucket: T = 768 + 1600 = 2368, and a
    static K/V of 24 x 2 x 8 x 2368 x 2048 x 2 B = 3552 MiB in bf16, 1776
    MiB int8 plus 55.5 MiB of scales.  Kernel A then runs at GB = 24 on
    the CFG steps and 8 on the others, where the K/V read is largest.

Each row: batch, speaker_latents, kv_mb_bf16, kv_mb_int8 (MiB, the
tensors' bytes), sampler_ms_bf16_kv, sampler_ms_int8_kv (the step loop
alone, after the prefill; median of --reps), speedup (bf16 / int8),
hbm_in_use_mb (torch.cuda.memory_allocated with the int8 K/V alive, None
on the CPU), latents_finite.

--w4a8 adds one row: 40 steps of a 24-layer scan of the MLP's w1 shape
(2048 -> 5888) at M = 120 rows, the streaming first block's (3 CFG rows x
40 latents), each layer's output cut back to 2048 columns as the next
input: with bf16 weights (`matmul`), W8A8 (ops.quant.int8_dot, kernel C)
and W4A8 (ops.quant.int4_dot: the K-halves nibble-packed weight unpacked
to int8 in plain PyTorch on every call, then kernel C), and the unpack
alone over the same calls.  At M = 120 kernel C is bound by its 12.1 MB
of int8 weight, and the unpack, which reads the packed and writes the
unpacked weight through several elementwise kernels, can cost more than
the product: the row says how much.

One JSON line: {"summary": [rows], "card": ...}.

    python -m echo_tts_torch.examples.bench_kv_quant --long-speaker --w4a8
    python -m echo_tts_torch.examples.bench_kv_quant --tiny --device cpu
"""
from __future__ import annotations

import math
import sys

import torch

from ..ops.quant import (int4_dot, int8_dot, quantize_weight_int4,
                         quantize_weight_int8, unpack_weight_int4)
from . import stages

LONG_SPEAKER = 6400                   # the largest speaker bucket
W4A8_FULL = (24, 120, 2048, 5888)     # layers, rows, K, N
W4A8_TINY = (2, 6, 64, 96)


def _mib(tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 2**20


def measure(models, lengths, batch: int, speaker: int, args) -> dict:
    model, dt = models.dit, models.dtype
    inputs = stages.request_inputs(models.dit_cfg, batch, lengths, speaker,
                                   models.device)
    plan = stages.step_plan(lengths.steps)
    pre = stages.prefill(model, inputs, dt)
    mb_bf16 = _mib(pre.kv_static)
    lat_bf16, bf16_runs = stages.timed_stage(
        lambda: stages.sampler(model, plan, pre, inputs, dt), args)
    del pre
    pre = stages.prefill(model, inputs, dt, kv_quant=True)
    mb_int8 = _mib(pre.kv_static.values())
    lat_int8, int8_runs = stages.timed_stage(
        lambda: stages.sampler(model, plan, pre, inputs, dt), args)
    bf16_ms, int8_ms = stages.median(bf16_runs), stages.median(int8_runs)
    return {
        "batch": batch, "speaker_latents": speaker,
        "static_columns": int(pre.spk_cols.shape[0]),
        "kv_mb_bf16": mb_bf16, "kv_mb_int8": mb_int8,
        "sampler_ms_bf16_kv": bf16_ms, "sampler_ms_int8_kv": int8_ms,
        "speedup": bf16_ms / int8_ms,
        "hbm_in_use_mb": stages.memory_mb(models.device),
        "latents_finite": bool(torch.isfinite(lat_bf16).all()
                               and torch.isfinite(lat_int8).all()),
        "ranges": {"sampler_ms_bf16_kv": stages.span(bf16_runs),
                   "sampler_ms_int8_kv": stages.span(int8_runs)},
    }


def w4a8_scan(device, shape, steps: int, args) -> dict:
    n_layers, m, k, n = shape
    g = torch.Generator(device=device).manual_seed(2)
    w = torch.randn((n_layers, n, k), generator=g, device=device) / math.sqrt(k)
    x0 = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    q8, s8 = quantize_weight_int8(w)
    q4, s4 = quantize_weight_int4(w)
    wbf = w.to(torch.bfloat16)
    del w

    def scan(dot):
        @torch.inference_mode()
        def run():
            c = x0
            for _ in range(steps):
                for layer in range(n_layers):
                    y = dot(c, layer)
                    c = (y[:, :k] / k).to(torch.bfloat16)
            return c
        return run

    @torch.inference_mode()
    def unpack_only():
        for _ in range(steps):
            for layer in range(n_layers):
                unpack_weight_int4(q4[layer])

    variants = {
        "scan_ms_bf16": scan(lambda c, i: torch.matmul(c, wbf[i].t()).float()),
        "scan_ms_w8a8": scan(lambda c, i: int8_dot(c, q8[i], s8[i],
                                                   torch.float32)),
        "scan_ms_w4a8_packed": scan(lambda c, i: int4_dot(c, q4[i], s4[i],
                                                          torch.float32)),
        "scan_ms_int4_unpack_only": unpack_only,
    }
    row = {"shape": f"{steps}x{n_layers}-layer scan, M={m}, {k}x{n}"}
    ranges = {}
    for key, fn in variants.items():
        _, runs = stages.timed_stage(fn, args)
        row[key], ranges[key] = stages.median(runs), stages.span(runs)
    row["ranges"] = ranges
    return row


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, steps=True)
    ap.add_argument("--long-speaker", action="store_true",
                    help="the B = 8 row over the 6400-latent speaker bucket")
    ap.add_argument("--skip-b8", action="store_true")
    ap.add_argument("--w4a8", action="store_true",
                    help="also the M = 120 scan in bf16, W8A8 and W4A8")
    args, models, lengths = stages.setup(ap, argv, models, blockwise=False)
    rows = [measure(models, lengths, 1, lengths.speaker, args)]
    if not args.skip_b8:
        rows.append(measure(models, lengths, 8,
                            LONG_SPEAKER if args.long_speaker
                            else lengths.speaker, args))
    if args.w4a8:
        rows.append(w4a8_scan(models.device,
                              W4A8_TINY if args.tiny else W4A8_FULL,
                              lengths.steps, args))
    return stages.emit({"summary": rows}, models.device)


if __name__ == "__main__":
    sys.exit(main())
