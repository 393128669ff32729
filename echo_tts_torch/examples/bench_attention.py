"""Kernel A on the card over a sweep of (S, T, GB) shapes, beside its plain
version and one library call.  Counterpart of examples/bench_attention.py.

At the published heads (H = 16, Dh = 128), bf16, every static column
valid, the static K/V batch GB / 3 (the CFG branches share it), each
shape times one call of:

  kernel_ms   ops/joint_attention.fused_joint_attention (kernel A,
              csrc/joint_attention.cu)
  plain_ms    joint_attention_plain, the plain PyTorch version the kernel
              is held against
  sdpa_ms     torch.nn.functional.scaled_dot_product_attention on [self |
              static] with the static K/V repeated over the branches and
              the mask as an additive bias: a yardstick only, the port
              never calls it

each the device time of --reps calls queued back to back (CUDA events),
with the card's bound for the same work (4 GB H S (S + T) Dh operations
at 989 TFLOP/s, or the bytes at 3.35 TB/s) and the kernel's rel-RMS from
the plain version.  The sweep reaches the long-utterance shapes (S >=
1280).  The TPU kernel's whole-row and flash forms and their tilings
have no counterpart: kernel A is one kernel for every shape, so each row
gives its tile plan instead (query rows per block, blocks, waves over the
132 SMs).  One JSON line: {"metric": "joint_attention_sweep", "rows":
[...]}.

    python -m echo_tts_torch.examples.bench_attention
    python -m echo_tts_torch.examples.bench_attention --tiny --device cpu
"""
from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from ..ops import cuda_build
from ..ops.joint_attention import (MASK_VALUE, _tile_plan,
                                   fused_joint_attention,
                                   joint_attention_plain)
from ..utils.profiling import bound, device_ms
from . import stages

SHAPES = [(640, 2432, 3), (640, 2432, 24), (1280, 2432, 3), (2048, 2432, 3)]
TINY_SHAPES = [(16, 48, 3), (16, 48, 6)]
H, DH = 16, 128
TINY_H, TINY_DH = 2, 16


def inputs(s: int, t: int, gb: int, h: int, dh: int, device, dtype,
           seed: int = 0):
    g = torch.Generator(device=device).manual_seed(seed)
    b = max(gb // 3, 1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    return (rnd(gb, s, h, dh), rnd(gb, s, h, dh), rnd(gb, s, h, dh),
            rnd(b, t, h, dh), rnd(b, t, h, dh),
            torch.ones((gb, t), dtype=torch.bool, device=device))


def sdpa_call(q, k_self, v_self, k_static, v_static, mask, sm_scale):
    """The same function as one library call (a yardstick): its operands
    (the static K/V repeated over the branches, the mask as an additive
    bias) are made here, and the call is returned to be timed alone."""
    rep = q.shape[0] // k_static.shape[0]
    k = torch.cat([k_self, k_static.repeat(rep, 1, 1, 1)], 1)
    v = torch.cat([v_self, v_static.repeat(rep, 1, 1, 1)], 1)
    bias = torch.cat([torch.zeros(mask.shape[0], q.shape[1],
                                  device=mask.device),
                      torch.where(mask, 0.0, MASK_VALUE)], 1)
    qb, kb, vb = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    am = bias[:, None, None, :].to(q.dtype)
    return lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=am,
                                                  scale=sm_scale)


@torch.inference_mode()
def row(s: int, t: int, gb: int, h: int, dh: int, device, dtype, reps: int
        ) -> dict:
    args = inputs(s, t, gb, h, dh, device, dtype)
    sm = dh ** -0.5
    out = fused_joint_attention(*args, sm_scale=sm)
    ref = joint_attention_plain(*args, sm_scale=sm)
    rel = float((out.float() - ref.float()).pow(2).mean().sqrt()
                / ref.float().pow(2).mean().sqrt())
    times = {}
    for name, fn in (
            ("kernel_ms", lambda: fused_joint_attention(*args, sm_scale=sm)),
            ("plain_ms", lambda: joint_attention_plain(*args, sm_scale=sm)),
            ("sdpa_ms", sdpa_call(*args, sm))):
        fn()                                        # warm-up
        times[name] = device_ms(fn, reps)
    b = args[3].shape[0]
    nbytes = 4 * gb * s * h * dh * 2 + 2 * b * t * h * dh * 2 + gb * t
    b_ms, b_by = bound(4.0 * gb * h * s * (s + t) * dh, nbytes)
    rows_per_block = _tile_plan(gb, s, h)
    blocks = math.ceil(s / rows_per_block) * h * gb
    return {"S": s, "T": t, "GB": gb, **times, "bound_ms": b_ms,
            "bound_by": b_by, "bound_share": b_ms / times["kernel_ms"],
            "rel_rms_vs_plain": rel,
            "tile_plan": {"query_rows_per_block": rows_per_block,
                          "blocks": blocks,
                          "waves": blocks / cuda_build.SMS}}


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, reps=20)
    args = stages.parse(ap, argv)
    dev = models.device if models is not None else stages.device(ap, args)
    shapes, h, dh, dtype = ((TINY_SHAPES, TINY_H, TINY_DH, torch.float32)
                            if args.tiny else (SHAPES, H, DH, torch.bfloat16))
    rows = [row(s, t, gb, h, dh, dev, dtype, args.reps)
            for s, t, gb in shapes]
    return stages.emit({"metric": "joint_attention_sweep", "rows": rows}, dev)


if __name__ == "__main__":
    sys.exit(main())
