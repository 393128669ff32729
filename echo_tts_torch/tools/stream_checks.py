"""Streamed against one-shot decode, and the two forms of the latent prefix,
at full width on one CUDA card.

    python -m echo_tts_torch.tools.stream_checks

Decode.  The seeded random serving codec (pipeline.random_models) decodes
640 seeded latents one-shot (decode_zq) and streamed on
growing_schedule(640) = [40, 80, 160, 320, 40] (decode_zq_block), and
compares:

  fp32_stream    an fp32 copy of the codec, the residual stacks' plain
                 version, TF32 off: streamed against one-shot.  The carried
                 state alone (windowed K/V, RoPE offsets, conv tails, the
                 residual histories, C = 768 included) separates the two;
  bf16_stream    the serving codec, kernel B: streamed (history form)
                 against one-shot (what chip_smoke.py's request (e) reads);
  bf16_kernel    the serving codec, one-shot, kernel B against the stacks'
                 plain version: how far the codec carries the kernel's own
                 rounding;
  bf16_vs_fp32   the serving codec's one-shot decode against the fp32
                 one: the bf16 decode's own error;
  bf16_stream_vs_fp32  the serving codec's streamed decode against the
                 fp32 one-shot decode (chip_smoke.py holds request (e)'s
                 streamed audio to the bf16 one-shot decode's own error
                 this way, and its fp32 pair to the JAX package's bound).

For each, the max-abs and rel-RMS of the audio, and the rel-RMS at every
stage's output (the post transformer, then each decoder block's residual
stack), the streamed stages concatenated over blocks.

Prefix.  The blockwise sampler's latent-prefix work for one stream on
growing_schedule(total), for totals 640, 2560 and 4440 (the most a
growing schedule reaches in MAX_STREAM_CHUNKS blocks): re-encoding the
whole prefix before every block after the first (get_kv_cache_latent), or
encoding each block once after it is sampled (latent_kv_append_block).
The DiT's step loop is the same either way, so this is the whole
difference.  Host-clock wall time with a sync around each call, median of
REPS streams.

The last line is one JSON object with every number.
"""
from __future__ import annotations

import contextlib
import copy
import json
import statistics
import sys
import time

import torch

from ..device import card_name
from ..models import dit as tdit
from ..models.dac import dac as tdac
from ..models.dac import streaming as tstream
from ..ops.res_stack import res_stack_plain
from ..pipeline import pipeline as pl
from ..serve.presets import growing_schedule

DECODE_TOTAL = 640
PREFIX_TOTALS = (640, 2560, 4440)
REPS = 3


def _plain_stack(x, weights, *, approx_snake=False, history=None):
    return res_stack_plain(x, *weights.plain_args(), approx_snake, history)


class _Stages:
    """Records the post transformer's and every residual stack's output, in
    call order, for the one-shot and the streamed decode alike."""

    def __init__(self):
        self.out = []

    def wrap(self, fn):
        def run(*a, **k):
            res = fn(*a, **k)
            self.out.append((res[0] if isinstance(res, tuple) else res).float())
            return res
        return run


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls and convolutions in full fp32 (cuDNN takes TF32 by
    default)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@torch.inference_mode()
def decode_pair(dac, z_q, schedule, *, plain: bool):
    """z_q (1, T, latent_dim) decoded one-shot and streamed on `schedule`
    (block sizes summing to T), with kernel B or, if `plain`, the residual
    stacks' plain version (no launch).  Returns (one-shot audio, streamed
    audio, one-shot stages, streamed stages), fp32, the stages being the
    post transformer's and each residual stack's output."""
    saved = (tdac.fused_res_stack, tdac._res_stack, tdac.transformer_forward,
             tstream._res_stack, tstream.transformer_decode_block)
    one, streamed = _Stages(), _Stages()
    try:
        if plain:
            tdac.fused_res_stack = _plain_stack
        tdac._res_stack = one.wrap(saved[1])
        tdac.transformer_forward = one.wrap(saved[2])
        a_one = tdac.decode_zq(dac, z_q).float()
        tstream._res_stack = streamed.wrap(saved[1])
        tstream.transformer_decode_block = streamed.wrap(saved[4])
        state = tstream.init_decode_state(dac.cfg, 1, z_q.dtype, z_q.device)
        parts, start = [], 0
        for n in schedule:
            a, state = tstream.decode_zq_block(dac, state, z_q[:, start:start + n])
            parts.append(a.float())
            start += n
    finally:
        (tdac.fused_res_stack, tdac._res_stack, tdac.transformer_forward,
         tstream._res_stack, tstream.transformer_decode_block) = saved
    n_stage = len(one.out)
    s_stages = [torch.cat(streamed.out[i::n_stage], dim=1) for i in range(n_stage)]
    return a_one, torch.cat(parts, dim=1), one.out, s_stages


def _rel_rms(got, want) -> float:
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def _compare(got, want, got_stages, want_stages) -> dict:
    return dict(max_abs=float((got - want).abs().max()),
                rel_rms=_rel_rms(got, want),
                stages=[_rel_rms(g, w) for g, w in zip(got_stages, want_stages)])


@torch.inference_mode()
def decode_checks(models) -> dict:
    gen = torch.Generator(device=models.device).manual_seed(11)
    latents = torch.randn((1, DECODE_TOTAL, models.dit_cfg.latent_size),
                          generator=gen, device=models.device)
    z_q = tdac.pca_unwhiten(latents, models.pca)
    schedule = growing_schedule(DECODE_TOTAL)
    with no_tf32():
        f_one, f_str, f_one_st, f_str_st = decode_pair(
            copy.deepcopy(models.dac).float(), z_q, schedule, plain=True)
    b_one, b_str, b_one_st, b_str_st = decode_pair(
        models.dac, z_q.bfloat16(), schedule, plain=False)
    p_one, _, p_one_st, _ = decode_pair(models.dac, z_q.bfloat16(), schedule,
                                        plain=True)
    return dict(
        stages=["post transformer"] + [
            f"decoder block {i} residual stack (C={models.dac_cfg.decoder_dim >> (i + 1)})"
            for i in range(len(models.dac_cfg.decoder_rates))],
        one_shot_audio=dict(peak=float(b_one.abs().max()),
                            rms=float(b_one.pow(2).mean().sqrt()),
                            saturated=float((b_one.abs() > 0.99).float().mean())),
        fp32_stream=_compare(f_str, f_one, f_str_st, f_one_st),
        bf16_stream=_compare(b_str, b_one, b_str_st, b_one_st),
        bf16_kernel=_compare(b_one, p_one, b_one_st, p_one_st),
        bf16_vs_fp32=_compare(b_one, f_one, b_one_st, f_one_st),
        bf16_stream_vs_fp32=_compare(b_str, f_one, b_str_st, f_one_st))


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


@torch.inference_mode()
def prefix_checks(models) -> list:
    model, cfg, dt = models.dit, models.dit_cfg, models.dtype
    ps = cfg.speaker_patch_size
    out = []
    for total in PREFIX_TOTALS:
        blocks = growing_schedule(total)
        gen = torch.Generator(device=models.device).manual_seed(total)
        prefix = torch.randn((1, total, cfg.latent_size), generator=gen,
                             device=models.device)

        def reencode():
            # before each block after the first, the whole zero-padded buffer
            return sum(_timed(lambda: tdit.get_kv_cache_latent(model, prefix.to(dt)))
                       for _ in blocks[1:])

        def incremental():
            state = tdit.init_latent_inc_state(cfg, 1, total // ps, dt, models.device)
            ms, start = 0.0, 0
            for n in blocks[:-1]:      # after each block but the last
                ms += _timed(lambda: tdit.latent_kv_append_block(
                    model, state, prefix[:, start:start + n].to(dt)))
                start += n
            return ms

        reencode(), incremental()      # warm-up
        re_ms = [reencode() for _ in range(REPS)]
        inc_ms = [incremental() for _ in range(REPS)]
        out.append(dict(total=total, blocks=len(blocks),
                        reencode_ms=statistics.median(re_ms),
                        incremental_ms=statistics.median(inc_ms),
                        reencode_runs=re_ms, incremental_runs=inc_ms))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_checks needs a CUDA card", file=sys.stderr)
        return 1
    card = card_name()
    print(card, flush=True)
    models = pl.random_models()
    dec = decode_checks(models)
    print(f"one-shot bf16 audio: {dec['one_shot_audio']}")
    for key in ("fp32_stream", "bf16_stream", "bf16_kernel", "bf16_vs_fp32",
                "bf16_stream_vs_fp32"):
        r = dec[key]
        print(f"{key}: max-abs {r['max_abs']:.3e} rel-RMS {r['rel_rms']:.3e}; "
              f"by stage " + ", ".join(f"{n} {v:.3e}"
                                       for n, v in zip(dec["stages"], r["stages"])),
              flush=True)
    pre = prefix_checks(models)
    for r in pre:
        print(f"prefix, total {r['total']} ({r['blocks']} blocks): re-encode "
              f"{r['reencode_ms']:.2f} ms, incremental {r['incremental_ms']:.2f} "
              f"ms per stream (runs {r['reencode_runs']}, {r['incremental_runs']})",
              flush=True)
    print(json.dumps(dict(card=card, decode=dec, prefix=pre)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
