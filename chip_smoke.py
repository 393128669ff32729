#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (echo_tts_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. device: CUDA must be present; prints the card's name and power limit;
     TF32 off for matmuls and cuDNN (cuDNN convs default to TF32, which
     would blur the plain versions the kernels are held against);
  2. build the three hand-written kernels from csrc/ (one nvcc each, in
     parallel) and print the build seconds and ptxas's report;
  3. the main path at full width with seeded random weights: four
     requests (no speaker; tests/data/voice.wav as speaker; a two-chunk
     text with that voice; and that voice again through the int8 serving
     modes, the W8A8 DiT from serve.models.load_models under
     ECHO_DIT_QUANT=int8 with kv_quant=True) through sample_pipeline /
     sample_pipeline_chunked, checking the audio and every kernel's launch
     count, with stage times and RTF; a fifth, (e), streams that voice
     through stream_synthesize on the growing schedule of 640 latents
     ([40, 80, 160, 320, 40]), checking its chunks, its launch counts
     (kernel B's history form apart) and its decode (an fp32 codec streams
     the same latents within 0.05 max-abs of its one-shot decode; the
     streamed bf16 audio is no farther from that fp32 decode than the
     one-shot bf16 decode is, within 1.25x), with each chunk's arrival time,
     time to first audio, streamed RTF and the playback stall; then the
     blockwise sampler with the incremental latent prefix against the
     re-encode, at reduced depth;
  4. each kernel against its plain PyTorch version on the card at the main
     path's shapes (and at ragged shapes shorter than one tile): joint
     attention with bf16 and with int8 static K/V, and at the streaming
     shapes (latent-prefix columns, part or a whole tile masked); the
     residual stack, one-shot and in its history form at streamed block
     shapes (new history checked too, zero history bit-equal to the
     one-shot kernel); and the W8A8 matmul (fp32 output within 1e-5 of the
     plain version, bf16 output rel-RMS); max-abs and rel-RMS error against
     the bound rel-RMS <= 1e-2 (for the residual stack also over its first
     row tile alone); kernel / plain / library device times (torch.profiler's sum
     of the device intervals the calls queue; kernel C's pre-pass and
     product together; the residual stack's three unit launches
     together), the host microseconds per wrapper call, the card's bound
     for the same work and the kernel's share of it; for the residual
     stack also the codec's unrolled path (three residual_unit calls) as
     a yardstick;
  5. one {"kernels": [...]} line; 6. the last line {"ok": true, ...}.
With --kernels-only it skips phase 3 and prints one {"cases": ...} line
after phase 4 instead, so that two trees' kernels can be timed in one call.
Imports nothing of JAX or of echo_tts_tpu.
"""
from __future__ import annotations

import copy
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 and int8
# tensor cores and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
INT8_FP32_BOUND = 1e-5  # W8A8 fp32 output vs plain (tests/test_quant.py:68)
REL_RMS_BOUND = 1e-2   # bf16 kernel vs plain (PARITY.md: bf16 vs fp32 1.05e-2)

VOICE = os.path.join(REPO, "tests", "data", "voice.wav")
TEXT = ("The quick brown fox jumps over the lazy dog, then reads it a "
        "bedtime story.")
STREAM_TOTAL = 640          # request (e): growing_schedule(640)
# Request (e)'s decode, held two ways.  An fp32 copy of the codec with the
# residual stacks' plain version decodes the stream's latents streamed, on
# the same schedule, and one-shot: the two agree within the JAX package's
# streamed-against-one-shot bound (tests/test_streaming.py:108), which
# tests the carried state at full width (kernel B's history form is held
# to its plain version in phase 4).  In bf16 the seeded random codec
# saturates its tanh and carries any rounding into sign flips, so that the
# one-shot bf16 decode is itself ~0.15 rel-RMS from the fp32 one
# (echo_tts_torch/tools/stream_checks.py): the streamed bf16 audio must be
# no farther from the fp32 one-shot decode than STREAM_BF16_RATIO times
# the one-shot bf16 decode is.
JAX_STREAM_BOUND = 0.05
STREAM_BF16_RATIO = 1.25
LONG_TEXT = (
    "The lighthouse keeper climbed the spiral stairs every evening at "
    "dusk, counting the steps as his father had taught him, and lit the "
    "great lamp that swept the dark water for passing ships. "
    "Tonight the sea was calm, the air smelled of salt and rain, and far "
    "out beyond the reef a single fishing boat rocked gently on the swell, "
    "its lantern glowing like a small and stubborn star against the "
    "gathering night.")


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int) -> dict:
    """One call of fn, after a warm-up: `ms`, its device time, the sum of
    the device intervals (kernels, copies, sets) that `reps` calls queue,
    as torch.profiler reads them, over reps; `by_name`, that sum split by
    kernel name; `host_us`, the host's microseconds to issue one call (the
    wall time of `reps` calls queued without a synchronise, over reps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    # a trace now and then comes back without its device events: take it
    # again (at most three times) rather than report nothing
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                span = (ev.time_range.end - ev.time_range.start) / 1e3 / reps
                by_name[ev.name] = by_name.get(ev.name, 0.0) + span
        ms = sum(by_name.values())
        if ms > 0:
            return dict(ms=ms, by_name=by_name, host_us=host_us)
        log("  (torch.profiler saw no device time; tracing again)")
    raise AssertionError("torch.profiler saw no device time")


def errors(got, want) -> tuple:
    """(max-abs, rel-RMS) of a kernel's output against its plain version;
    raises on a non-finite output."""
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError("kernel output has non-finite values")
    max_abs = float((g - w).abs().max())
    rel_rms = float(((g - w).pow(2).mean().sqrt()) / w.pow(2).mean().sqrt())
    return max_abs, rel_rms


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple:
    """(ms, what bounds it): the larger of ops at the operand type's peak
    rate and bytes at the memory rate."""
    t_ops = ops / peak * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from echo_tts_torch.ops import cuda_build
    t0 = time.perf_counter()
    secs = cuda_build.build()
    log(f"build: {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.1f} s")
    for name in cuda_build.KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
        cuda_build.load(name)


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_case(gb: int, s: int, t: int, seed: int, kv8: bool = False,
                   n_lat: int = 0, lat_valid: int = 0):
    """Kernel A at one shape; kv8 stores the static K/V int8 (the port's
    quantize_kv_int8 of the same bf16 K/V) and passes their scales.  With
    n_lat, the static columns are [latent, text, speaker] as a streamed
    block after the first has them, the latent columns from lat_valid on
    masked in every row (positions at or past the block's start)."""
    import torch
    from echo_tts_torch.ops import joint_attention as ja
    from echo_tts_torch.ops import quant
    h, dh, b = 16, 128, 1
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, ks, vs = rnd(gb, s, h, dh), rnd(gb, s, h, dh), rnd(gb, s, h, dh)
    kt, vt = rnd(b, t, h, dh), rnd(b, t, h, dh)
    t_text = 768
    n_text = 96                       # real bytes of a short prompt
    text = torch.zeros((t,), dtype=torch.bool, device=dev)
    text[n_lat:n_lat + min(n_text, t_text)] = True
    spk = torch.zeros((t,), dtype=torch.bool, device=dev)
    spk[n_lat + t_text:] = True
    lat = torch.zeros((t,), dtype=torch.bool, device=dev)
    lat[:lat_valid] = True
    cond = lat | text | spk
    rows = ([cond, lat | spk, lat | text][:gb] if gb == 3 else [cond] * gb)
    mask = torch.stack(rows)          # CFG branches blank whole segments
    col_scale = torch.where(spk, 1.5, 1.0).float()
    sm = dh ** -0.5
    kw = dict(sm_scale=sm)
    kv_bytes = 2                      # per static K/V element
    if kv8:
        qkv = quant.quantize_kv_int8(kt, vt)
        kw["kv_scales"] = (qkv["ks"], qkv["vs"])
        kt8, vt8 = qkv["k8"], qkv["v8"]
        args = (q, ks, vs, kt8, vt8, mask, col_scale)
        # the library yardstick below reads the dequantized K/V
        kt, vt = quant.dequantize_kv(qkv)
        kv_bytes = 1
    else:
        args = (q, ks, vs, kt, vt, mask, col_scale)

    out = ja.fused_joint_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = ja.joint_attention_plain(*args, **kw)
    max_abs, rel = errors(out, ref)
    latent = f" latent {lat_valid}/{n_lat}" if n_lat else ""
    name = (f"joint attention{' int8 K/V' if kv8 else ''} GB={gb} S={s} "
            f"T={t}{latent}")
    if rel > REL_RMS_BOUND:
        raise AssertionError(f"{name}: rel-RMS {rel:.3e} > {REL_RMS_BOUND}")
    kernel = timed(lambda: ja.fused_joint_attention(*args, **kw), 50)
    kernel_ms = kernel["ms"]
    plain_ms = timed(lambda: ja.joint_attention_plain(*args, **kw), 5)["ms"]
    # yardstick only: one library call on [self | static] with K and V
    # pre-scaled and the bias as an additive mask; the port never calls it
    import torch.nn.functional as F
    kb = torch.cat([ks, (kt * col_scale[None, :, None, None].to(kt.dtype))
                    .expand(gb, t, h, dh)], 1).transpose(1, 2).contiguous()
    vb = torch.cat([vs, (vt * col_scale[None, :, None, None].to(vt.dtype))
                    .expand(gb, t, h, dh)], 1).transpose(1, 2).contiguous()
    qb = q.transpose(1, 2).contiguous()
    bias = torch.where(mask, 0.0, ja.MASK_VALUE).float()
    am = torch.cat([torch.zeros((gb, s), device=dev), bias], 1)[:, None, None, :]
    am = am.to(torch.bfloat16)
    library_ms = timed(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=am, scale=sm), 50)["ms"]
    flops = 4.0 * gb * h * s * (s + t) * dh
    # q, k_self, v_self, out bf16; static K/V; their int8 scales; mask;
    # column scale
    nbytes = (4 * gb * s * h * dh * 2 + 2 * b * t * h * dh * kv_bytes
              + (2 * b * t * h * 4 if kv8 else 0) + gb * t + t * 4)
    b_ms, b_by = bound(flops, nbytes)
    res = dict(shape=f"GB={gb} S={s} T={t} H={h} Dh={dh}"
               + (" int8 K/V" if kv8 else "") + latent, max_abs_err=max_abs,
               rel_rms=rel, ms=kernel_ms, host_us=kernel["host_us"],
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by)
    log(f"  attention {res['shape']}: max_abs {max_abs:.3e} rel_rms {rel:.3e}"
        f" (bound {REL_RMS_BOUND}) kernel_ms {kernel_ms:.4f} host_us "
        f"{kernel['host_us']:.1f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by})")
    return res


def res_stack_inputs(c: int, length: int, seed: int):
    """(rnd, x, args, weights): kernel B's inputs at one shape, bf16 on the
    card, and the generator-backed rnd(shape, std) that drew them."""
    import torch
    from echo_tts_torch.ops import res_stack as rs
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape, std):
        return (torch.randn(shape, generator=g, device=dev) * std).to(torch.bfloat16)

    x = rnd((1, length, c), 0.5)
    w1 = rnd((3, 7, c, c), (7 * c) ** -0.5)
    w2 = rnd((3, c, c), c ** -0.5)
    # biases large enough that a kernel whose context before the sequence
    # start were not zero at each unit's k7 input would miss the bound on
    # the first tile (tests/test_torch_res_stack.py holds that margin)
    b1, b2 = rnd((3, c), 0.1), rnd((3, c), 0.1)
    a1 = (1.0 + 0.1 * torch.randn((3, c), generator=g, device=dev)).to(torch.bfloat16)
    a2 = (1.0 + 0.1 * torch.randn((3, c), generator=g, device=dev)).to(torch.bfloat16)
    args = (w1, b1, a1, w2, b2, a2)
    return rnd, x, args, rs.ResStackWeights(*args)


def res_stack_case(c: int, length: int, approx: bool, seed: int):
    import torch
    from echo_tts_torch.models.dac.conv import residual_unit
    from echo_tts_torch.ops import res_stack as rs
    _, x, args, weights = res_stack_inputs(c, length, seed)
    w1, b1, a1, w2, b2, a2 = args

    out = rs.fused_res_stack(x, weights, approx_snake=approx)
    torch.cuda.synchronize()
    ref = rs.res_stack_plain(x, *args, approx_snake=approx)
    max_abs, rel = errors(out, ref)
    # the first row tile on its own: the context before the sequence start
    # touches only the first 78 frames, and the whole-L error would dilute
    # a fault there below any bound.  (A tree from before the per-unit
    # kernel has no tile_plan: there the first block and its context.)
    cp = weights.kernel_layout()[0]
    head = (rs.tile_plan(cp)["bm"] if hasattr(rs, "tile_plan")
            else rs.HALO + rs.block_length(cp))
    _, rel_head = errors(out[:, :head], ref[:, :head])
    if rel > REL_RMS_BOUND or rel_head > REL_RMS_BOUND:
        raise AssertionError(f"res stack C={c} L={length} approx={approx}: "
                             f"rel-RMS {rel:.3e}, first {head} frames "
                             f"{rel_head:.3e}, bound {REL_RMS_BOUND}")
    reps = 5 if length > 4096 else 50
    kernel = timed(lambda: rs.fused_res_stack(x, weights, approx_snake=approx),
                   reps)
    kernel_ms = kernel["ms"]
    plain_ms = timed(lambda: rs.res_stack_plain(x, *args, approx_snake=approx),
                     max(3, reps // 5))["ms"]

    # yardstick only, not a library call for the same function: the codec's
    # unrolled path (three residual_unit calls on cuBLAS/ATen), which it
    # runs above C = 384
    def unrolled():
        y = x
        for u, d in enumerate(rs.DILATIONS):
            y = residual_unit(y, a1[u], w1[u], b1[u], a2[u], w2[u][None],
                              b2[u], d, approx_snake=approx)
        return y

    unrolled_ms = timed(unrolled, max(3, reps // 5))["ms"]
    flops = 3 * 2.0 * 8 * c * c * length
    nbytes = 2 * length * c * 2 + 3 * 8 * c * c * 2 + 3 * 4 * c * 2
    b_ms, b_by = bound(flops, nbytes)
    res = dict(shape=f"C={c} L={length} snake={'sin2_poly' if approx else 'exact'}",
               max_abs_err=max_abs, rel_rms=max(rel, rel_head), ms=kernel_ms,
               host_us=kernel["host_us"], plain_ms=plain_ms, library_ms=None,
               unrolled_ms=unrolled_ms, bound_ms=b_ms, bound_by=b_by,
               bound_share=b_ms / kernel_ms)
    log(f"  res_stack {res['shape']}: max_abs {max_abs:.3e} rel_rms {rel:.3e}"
        f" first {head} frames {rel_head:.3e} (bound {REL_RMS_BOUND}) kernel_ms "
        f"{kernel_ms:.4f} host_us {kernel['host_us']:.1f} plain_ms "
        f"{plain_ms:.4f} unrolled_ms {unrolled_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by}), {100 * b_ms / kernel_ms:.1f} % of the bound")
    return res


def res_stack_history_case(c: int, length: int, approx: bool, seed: int):
    """Kernel B's history form at one streamed block's shape, with a random
    non-zero history: the output over the whole block and over its first
    row tile (where the history is read), and the new history, against
    the plain version's; and zero history against the one-shot kernel,
    bit for bit."""
    import torch
    from echo_tts_torch.models.dac.conv import residual_unit
    from echo_tts_torch.ops import res_stack as rs
    rnd, x, args, weights = res_stack_inputs(c, length, seed)
    w1, b1, a1, w2, b2, a2 = args
    hist = [rnd((1, 6 * d, c), 0.5) for d in rs.DILATIONS]
    kw = dict(approx_snake=approx, history=hist)

    out, new = rs.fused_res_stack(x, weights, **kw)
    torch.cuda.synchronize()
    ref, ref_new = rs.res_stack_plain(x, *args, approx, history=hist)
    max_abs, rel = errors(out, ref)
    head = rs.tile_plan(weights.kernel_layout()[0])["bm"]
    _, rel_head = errors(out[:, :head], ref[:, :head])
    rel_hist = max(errors(a, b)[1] for a, b in zip(new, ref_new))
    zero_out, _ = rs.fused_res_stack(
        x, weights, approx_snake=approx,
        history=[torch.zeros_like(h) for h in hist])
    bit_equal = torch.equal(zero_out, rs.fused_res_stack(x, weights,
                                                         approx_snake=approx))
    torch.cuda.synchronize()
    name = f"res stack history C={c} L={length} approx={approx}"
    if max(rel, rel_head, rel_hist) > REL_RMS_BOUND or not bit_equal:
        raise AssertionError(
            f"{name}: rel-RMS {rel:.3e}, first {head} frames {rel_head:.3e}, "
            f"new history {rel_hist:.3e} (bound {REL_RMS_BOUND}); zero "
            f"history bit-equal to the one-shot kernel: {bit_equal}")
    reps = 5 if length > 4096 else 50
    kernel = timed(lambda: rs.fused_res_stack(x, weights, **kw), reps)
    plain_ms = timed(lambda: rs.res_stack_plain(x, *args, approx, history=hist),
                     max(3, reps // 5))["ms"]

    # yardstick only: the codec's unrolled units in their history form
    # (three residual_unit calls on cuBLAS/ATen), its path above C = 384
    def unrolled():
        y = x
        for u, d in enumerate(rs.DILATIONS):
            y, _ = residual_unit(y, a1[u], w1[u], b1[u], a2[u], w2[u][None],
                                 b2[u], d, approx_snake=approx, history=hist[u])
        return y

    unrolled_ms = timed(unrolled, max(3, reps // 5))["ms"]
    flops = 3 * 2.0 * 8 * c * c * length
    hist_rows = 6 * sum(rs.DILATIONS)
    # x read, out written, the weights, the history read and written
    nbytes = (2 * length * c * 2 + 3 * 8 * c * c * 2 + 3 * 4 * c * 2
              + 2 * hist_rows * c * 2)
    b_ms, b_by = bound(flops, nbytes)
    res = dict(shape=(f"C={c} L={length} snake={'sin2_poly' if approx else 'exact'}"
                      " history"),
               max_abs_err=max_abs, rel_rms=max(rel, rel_head, rel_hist),
               rel_rms_history=rel_hist, zero_history_bit_equal=bit_equal,
               ms=kernel["ms"], host_us=kernel["host_us"], plain_ms=plain_ms,
               library_ms=None, unrolled_ms=unrolled_ms, bound_ms=b_ms,
               bound_by=b_by, bound_share=b_ms / kernel["ms"])
    log(f"  res_stack {res['shape']}: max_abs {max_abs:.3e} rel_rms {rel:.3e}"
        f" first {head} frames {rel_head:.3e} new history {rel_hist:.3e} "
        f"(bound {REL_RMS_BOUND}), zero history bit-equal {bit_equal}; "
        f"kernel_ms {kernel['ms']:.4f} host_us {kernel['host_us']:.1f} "
        f"plain_ms {plain_ms:.4f} unrolled_ms {unrolled_ms:.4f} bound_ms "
        f"{b_ms:.4f} ({b_by}), {100 * b_ms / kernel['ms']:.1f} % of the bound")
    return res


def int8_matmul_case(m: int, k: int, n: int, seed: int):
    """Kernel C at one (M, K, N) of the W8A8 DiT: x bf16, the weight
    quantized by the port's quantize_weight_int8."""
    import torch
    from echo_tts_torch.ops import int8_matmul as im
    from echo_tts_torch.ops import quant
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=g, device=dev) * k ** -0.5).to(torch.bfloat16)
    w8, ws = quant.quantize_weight_int8(w)

    out32 = im.int8_matmul_fused(x, w8, ws, torch.float32)
    torch.cuda.synchronize()
    max_abs32, _ = errors(out32, im.int8_matmul_plain(x, w8, ws, torch.float32))
    out = im.int8_matmul_fused(x, w8, ws)
    torch.cuda.synchronize()
    max_abs, rel = errors(out, im.int8_matmul_plain(x, w8, ws))
    name = f"int8_matmul M={m} K={k} N={n}"
    if max_abs32 > INT8_FP32_BOUND or rel > REL_RMS_BOUND:
        raise AssertionError(f"{name}: fp32 max-abs {max_abs32:.3e} (bound "
                             f"{INT8_FP32_BOUND}), bf16 rel-RMS {rel:.3e} "
                             f"(bound {REL_RMS_BOUND})")
    _, rel_bf16 = errors(out, x @ w.t())      # the mode's own error, shown
    kernel = timed(lambda: im.int8_matmul_fused(x, w8, ws), 50)
    kernel_ms = kernel["ms"]
    # kernel C's time is its two launches together; the pre-pass apart
    prepass_ms = sum(v for k, v in kernel["by_name"].items()
                     if "quantize_rows" in k)
    plain_ms = timed(lambda: im.int8_matmul_plain(x, w8, ws), 5)["ms"]
    # yardsticks only, never called by the port: the library's int8 product
    # alone on pre-quantized operands, and the bf16 product it replaces
    xq = im.quantize_last(x, 127.0)[0].to(torch.int8)
    library_ms = timed(lambda: torch._int_mm(xq, w8.t()), 50)["ms"]
    bf16_ms = timed(lambda: torch.matmul(x, w.t()), 50)["ms"]
    # x bf16, w int8, w_scale fp32 read once; out bf16 written once
    nbytes = m * k * 2 + n * k + n * 4 + m * n * 2
    b_ms, b_by = bound(2.0 * m * k * n, nbytes, PEAK_INT8_OPS)
    res = dict(shape=f"M={m} K={k} N={n}", max_abs_err=max_abs32,
               max_abs_err_bf16=max_abs, rel_rms=rel, ms=kernel_ms,
               prepass_ms=prepass_ms, host_us=kernel["host_us"],
               plain_ms=plain_ms, library_ms=library_ms,
               bf16_matmul_ms=bf16_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"  {name}: fp32 max_abs {max_abs32:.3e} (bound {INT8_FP32_BOUND}) "
        f"bf16 max_abs {max_abs:.3e} rel_rms {rel:.3e} (bound "
        f"{REL_RMS_BOUND}); W8A8 vs bf16 matmul rel_rms {rel_bf16:.3e}; "
        f"kernel_ms {kernel_ms:.4f} (pre-pass {prepass_ms:.4f}) host_us "
        f"{kernel['host_us']:.1f} plain_ms {plain_ms:.4f} _int_mm_ms "
        f"{library_ms:.4f} bf16_matmul_ms {bf16_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by})")
    return res


def phase_kernels():
    log("phase 4: kernels vs plain")
    # ragged edges first: query rows and self columns past S = 150, static
    # columns past T = 300, two and six CFG branches over one static K/V
    # row; a W8A8 product with M, K and N each shorter than one tile, and
    # one with ragged M, K and N and more tiles than SMs (some blocks take
    # two)
    edges = [attention_case(gb, 150, 300, seed=60 + gb, kv8=kv8)
             for gb in (2, 6) for kv8 in (False, True)]
    edges += [int8_matmul_case(37, 96, 64, seed=64),
              int8_matmul_case(1000, 272, 4104, seed=65)]
    att = [attention_case(gb, 640, t, seed=i) for i, (gb, t) in enumerate(
        [(3, 778), (1, 778), (3, 2368), (1, 2368)])]
    att.append(attention_case(3, 1280, 778, seed=9))
    # request (e)'s streaming shapes: its first block (no latent segment),
    # its block of 320 at 280 (160 latent columns, 70 before the start)
    # and of 80 at 40 (10); and a block of 320 at 280 in a 1280-latent
    # stream, whose latent columns 128-255, a whole static tile, are
    # masked in every row
    att_stream = [attention_case(gb, s, t, seed=70 + i, n_lat=n_lat,
                                 lat_valid=valid)
                  for i, (gb, s, t, n_lat, valid) in enumerate(
                      [(3, 40, 778, 0, 0), (3, 320, 938, 160, 70),
                       (1, 80, 938, 160, 10), (3, 320, 1098, 320, 70)])]
    att += att_stream
    # int8 static K/V at request (d)'s shapes (GB=3 and 1, T=778) and at
    # the longest static K/V
    att8 = [attention_case(gb, 640, t, seed=30 + i, kv8=True)
            for i, (gb, t) in enumerate([(3, 778), (1, 778), (3, 2368)])]
    att8 += [r for r in edges[:4] if "int8" in r["shape"]]
    att += [r for r in edges[:4] if "int8" not in r["shape"]]
    # every (M, K, N) the W8A8 DiT gives kernel C: M = 1920 on CFG steps
    # (GB=3), 640 else; wq/wk/wv/gate/wo (2048, 2048), w1/w3 (2048, 5888),
    # w2 (5888, 2048)
    mm = [int8_matmul_case(m, k, n, seed=40 + i) for i, (m, k, n) in enumerate(
        [(1920, 2048, 5888), (1920, 2048, 2048), (1920, 5888, 2048),
         (640, 2048, 5888), (640, 2048, 2048), (640, 5888, 2048)])]
    mm += edges[4:]
    # every (C, L, snake) the main path gives the kernel for 640 latents:
    # decoder blocks 1-3 with the serving decoder's sin2_poly, speaker
    # encoder blocks 0-2 with exact sin; the two decoder widths' other
    # snake; and blocks shorter than one tile, as short decodes give
    rst = [res_stack_case(c, length, approx, seed=20 + i)
           for i, (c, length, approx) in enumerate(
               [(96, 1310720, True), (192, 655360, True), (384, 163840, True),
                (64, 1310720, False), (128, 655360, False),
                (256, 163840, False), (96, 1310720, False),
                (384, 163840, False), (96, 300, True), (384, 40, False)])]
    # the history form at the decoder's shapes for blocks of 40 and 320
    # latents (L = 256, 1024, 2048 frames a latent at C = 384, 192, 96),
    # with sin2_poly, and an encoder-side shape (C = 64) with exact sin
    rst += [res_stack_history_case(c, length, approx, seed=80 + i)
            for i, (c, length, approx) in enumerate(
                [(384, 10240, True), (192, 40960, True), (96, 81920, True),
                 (384, 81920, True), (192, 327680, True), (96, 655360, True),
                 (64, 2048, False)])]
    return att, att8, rst, mm


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def phase_main_path():
    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.ops import quant
    from echo_tts_torch.ops.int8_matmul import int8_matmul_fused
    from echo_tts_torch.ops.joint_attention import fused_joint_attention
    from echo_tts_torch.ops.res_stack import fused_res_stack
    from echo_tts_torch.pipeline import audio_io, pipeline as pl
    from echo_tts_torch.pipeline.text import chunk_text, get_text_input_ids_and_mask
    from echo_tts_torch.sampler.euler import make_cfg_branch_masks
    from echo_tts_torch.serve import models as serve_models

    log("phase 3: main path (full width, seeded random weights)")
    t0 = time.perf_counter()
    models = pl.random_models()
    torch.cuda.synchronize()
    log(f"  random_models: {time.perf_counter() - t0:.1f} s, DiT "
        f"{sum(p.numel() for p in models.dit.parameters()) / 1e9:.3f} B params, "
        f"codec {sum(p.numel() for p in models.dac.parameters()) / 1e9:.3f} B")
    # request (d)'s bundle through the serving loader, in the int8 mode;
    # the same seed as `models`, so the two DiTs hold the same weights
    t0 = time.perf_counter()
    saved_mode = os.environ.get("ECHO_DIT_QUANT")
    os.environ["ECHO_DIT_QUANT"] = "int8"
    try:
        serve_models.clear_models()
        qmodels = serve_models.load_models(None, allow_random=True)
        if serve_models.served_quant_mode() != "int8":
            raise AssertionError("load_models did not serve the W8A8 DiT")
    finally:
        if saved_mode is None:
            os.environ.pop("ECHO_DIT_QUANT")
        else:
            os.environ["ECHO_DIT_QUANT"] = saved_mode
    torch.cuda.synchronize()
    log(f"  serve.models.load_models(ECHO_DIT_QUANT=int8): "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = models.dit_cfg
    n_layers, n_steps = cfg.num_layers, SAMPLER_DEFAULTS["num_steps"]
    n_int8_linears = len(quant.DIT_BLOCK_QUANT_KEYS)
    sample_fn = functools.partial(pl.euler_sample_fn, **SAMPLER_DEFAULTS)
    sample_fn_q = functools.partial(pl.euler_sample_fn, kv_quant=True,
                                    **SAMPLER_DEFAULTS)
    voice = audio_io.load_audio(VOICE)
    spl = models.dac_cfg.frame_length
    n_voice_chunks = math.ceil(voice.shape[1] / (640 * spl))
    chunks = chunk_text(LONG_TEXT)
    if len(chunks) != 2:
        raise AssertionError(f"long text splits into {len(chunks)} chunks")

    # record every decoded waveform before the end-of-speech crop
    decoded = []
    crop = pl.dsp.crop_audio_to_flattening_point

    def recording_crop(audio, latent, samples_per_latent):
        decoded.append((audio.shape, bool(np.isfinite(audio).all()),
                        float(np.abs(audio).max())))
        return crop(audio, latent, samples_per_latent=samples_per_latent)

    stage = {"sampler": [], "decode": []}
    decode = pl.ae_decode

    def timing(fn, key):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            stage[key].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    timed_sample_fn = timing(sample_fn, "sampler")
    timed_sample_fn_q = timing(sample_fn_q, "sampler")
    pl.dsp.crop_audio_to_flattening_point = recording_crop
    pl.ae_decode = timing(decode, "decode")
    # (name, run, sampler calls, encoded speaker chunks, int8 modes)
    requests = [
        ("a: sample_pipeline, no speaker", lambda: pl.sample_pipeline(
            models, timed_sample_fn, TEXT, None, 0), 1, 0, False),
        ("b: sample_pipeline, voice.wav", lambda: pl.sample_pipeline(
            models, timed_sample_fn, TEXT, voice, 1), 1, n_voice_chunks, False),
        ("c: sample_pipeline_chunked, 2 chunks, voice.wav",
         lambda: pl.sample_pipeline_chunked(
             models, timed_sample_fn, LONG_TEXT, voice, 2), 2, n_voice_chunks,
         False),
        ("d: sample_pipeline, voice.wav, W8A8 DiT + int8 K/V",
         lambda: pl.sample_pipeline(
             qmodels, timed_sample_fn_q, TEXT, voice, 1), 1, n_voice_chunks,
         True),
    ]
    counters = {"joint_attention": (fused_joint_attention, "launches"),
                "joint_attention_kv8": (fused_joint_attention, "launches_kv8"),
                "int8_matmul": (int8_matmul_fused, "launches"),
                "res_stack": (fused_res_stack, "launches"),
                "res_stack_stream": (fused_res_stack, "launches_stream")}
    launches = dict.fromkeys(counters, 0)
    request_stats = {}
    try:
        for name, run, n_samples, n_enc, int8_modes in requests:
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            n_dec = len(decoded)
            torch.cuda.synchronize()
            t = time.perf_counter()
            audio, _ = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
            for k, v in got.items():
                launches[k] += v
            attn = n_layers * n_steps * n_samples
            want = {"joint_attention": 0 if int8_modes else attn,
                    "joint_attention_kv8": attn if int8_modes else 0,
                    "int8_matmul": n_int8_linears * attn if int8_modes else 0,
                    "res_stack": 3 * n_samples + 3 * n_enc,
                    "res_stack_stream": 0}
            if got != want:
                raise AssertionError(f"{name}: launches {got}, want {want}")
            for shape, finite, peak in decoded[n_dec:]:
                if shape != (1, 640 * spl) or not finite or peak <= 1e-4:
                    raise AssertionError(f"{name}: decoded {shape} finite "
                                         f"{finite} peak {peak}")
            if audio.ndim != 2 or audio.shape[1] == 0 or not np.isfinite(audio).all():
                raise AssertionError(f"{name}: audio {audio.shape}")
            secs = audio.shape[1] / models.dac_cfg.sample_rate
            request_stats[name[0]] = dict(
                wall_ms=wall * 1e3, rtf=secs / wall,
                sampler_ms=stage["sampler"][-n_samples:],
                decode_ms=stage["decode"][-n_samples:])
            log(f"  request {name}: {wall * 1e3:.1f} ms wall, {secs:.2f} s "
                f"audio, RTF {secs / wall:.3f}x realtime; launches {got}; "
                f"sampler_ms "
                f"{[round(v, 1) for v in stage['sampler'][-n_samples:]]} "
                f"decode_ms {[round(v, 1) for v in stage['decode'][-n_samples:]]}")
    finally:
        pl.dsp.crop_audio_to_flattening_point = crop
        pl.ae_decode = decode

    # prefill alone (request b's inputs), outside the counted run
    lat, mask = pl.get_speaker_latent_and_mask(models, voice)
    ids, tmask = get_text_input_ids_and_mask([TEXT], 768)
    dev = models.device
    ids_t, tmask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(tmask).to(dev)
    lat_t = torch.from_numpy(lat).to(dev).to(models.dtype)
    smask_t = torch.from_numpy(mask).to(dev)

    def prefill():
        with torch.inference_mode():
            kv_t = tdit.get_kv_cache_text(models.dit, ids_t, tmask_t)
            kv_s = tdit.get_kv_cache_speaker(models.dit, lat_t)
            return tdit.concat_static_kv(kv_t, kv_s)

    prefill()                                   # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) / 3 * 1e3    # wall, host clock
    for key in ("b", "d"):
        log(f"  stage ms (request {key}): prefill (bf16 DiT) {prefill_ms:.1f}, "
            f"sampler (incl. prefill) {request_stats[key]['sampler_ms'][0]:.1f}, "
            f"decode {request_stats[key]['decode_ms'][0]:.1f}")

    # information only, not a gate: one full-width CFG forward (GB=3) of the
    # W8A8 DiT over int8 K/V against the bf16 DiT over bf16 K/V, on the
    # same inputs and weights
    with torch.inference_mode():
        kv, spk_cols = prefill()
        mask_cfg, _ = make_cfg_branch_masks(cfg, tmask_t, smask_t)
        g = torch.Generator(device=dev).manual_seed(50)
        x = torch.randn((3, 640, cfg.latent_size), generator=g,
                        device=dev).to(models.dtype)
        t = torch.full((3,), 0.7, device=dev).to(models.dtype)
        ref = tdit.dit_forward_static(models.dit, x, t, kv, spk_cols, mask_cfg)
        got = tdit.dit_forward_static(qmodels.dit, x, t,
                                      quant.quantize_kv_int8(*kv), spk_cols,
                                      mask_cfg)
        _, rel = errors(got, ref)
    log(f"  W8A8 + int8 K/V vs bf16, one dit_forward_static at GB=3 S=640 "
        f"T={kv[0].shape[2]}: rel-RMS {rel:.3e} (information only)")

    got = request_stream(models, voice, counters, n_voice_chunks)
    for k, v in got.items():
        launches[k] += v
    incremental_check(models, lat, mask, ids_t, tmask_t)
    return launches


def request_stream(models, voice, counters, n_voice_chunks: int) -> dict:
    """Request (e): stream_synthesize on the growing schedule of
    STREAM_TOTAL latents with voice.wav.  Checks the chunks, the launch
    counts (24 x 40 attention per block, kernel B's history form three
    times per block, its one-shot form three times per encoded speaker
    chunk) and the concatenated audio against the one-shot ae_decode of
    the same latents (see JAX_STREAM_BOUND and STREAM_BF16_RATIO); prints
    each chunk's arrival on the host clock, the time to first audio, the
    streamed RTF and the playback stall of a listener who starts at first
    audio.  Returns the launch counts."""
    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS, growing_schedule, stream_synthesize
    from echo_tts_torch.models.dac.dac import pca_unwhiten
    from echo_tts_torch.pipeline import pipeline as pl
    from echo_tts_torch.serve import streaming as sst
    from echo_tts_torch.tools.stream_checks import decode_pair, no_tf32

    schedule = growing_schedule(STREAM_TOTAL)
    cfg = models.dit_cfg
    spl, rate = models.dac_cfg.frame_length, models.dac_cfg.sample_rate
    blocks, decode_ms = [], []
    block_decode = sst.ae_decode_block

    def recording_decode(m, state, latents):
        # the latents each block decodes, and the decode's own wall time
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = block_decode(m, state, latents)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        blocks.append(latents.clone())
        return out

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    sst.ae_decode_block = recording_decode
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks, arrivals = [], []
        for chunk in stream_synthesize(models, TEXT, voice,
                                       chunk_sizes=schedule, seed=5):
            arrivals.append(time.perf_counter() - t0)
            chunks.append(chunk)
    finally:
        sst.ae_decode_block = block_decode
    got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    n = len(schedule)
    want = {"joint_attention": cfg.num_layers * SAMPLER_DEFAULTS["num_steps"] * n,
            "joint_attention_kv8": 0, "int8_matmul": 0,
            "res_stack": 3 * n_voice_chunks, "res_stack_stream": 3 * n}
    name = f"e: stream_synthesize, voice.wav, chunk_sizes={schedule}"
    if got != want:
        raise AssertionError(f"{name}: launches {got}, want {want}")
    ends = list(np.cumsum(schedule))
    if ([c.index for c in chunks] != list(range(n))
            or [(c.latent_start, c.latent_end) for c in chunks]
            != list(zip([0] + ends[:-1], ends))
            or [c.is_last for c in chunks] != [False] * (n - 1) + [True]):
        raise AssertionError(f"{name}: chunks {[(c.index, c.latent_start, c.latent_end, c.is_last) for c in chunks]}")
    for c, size in zip(chunks, schedule):
        if (c.audio.shape != (1, size * spl) or not np.isfinite(c.audio).all()
                or float(np.abs(c.audio).max()) <= 1e-4):
            raise AssertionError(f"{name}: chunk {c.index} audio "
                                 f"{c.audio.shape}, peak "
                                 f"{float(np.abs(c.audio).max())}")
    streamed = torch.from_numpy(np.concatenate([c.audio for c in chunks], -1))
    latents = torch.cat(blocks, dim=1)
    one_shot = pl.ae_decode(models, latents).cpu()
    with no_tf32():
        one32, str32, _, _ = decode_pair(
            copy.deepcopy(models.dac).float(),
            pca_unwhiten(latents.float(), models.pca), schedule, plain=True)
    one32, str32 = one32[..., 0].cpu(), str32[..., 0].cpu()
    fp32_max_abs, fp32_rel = errors(str32, one32)
    bf16_max_abs, bf16_rel = errors(streamed, one_shot)
    err_one, err_stream = errors(one_shot, one32)[1], errors(streamed, one32)[1]
    # below 1e-3 an error is rounding at any precision, not a fault
    ratio = err_stream / max(err_one, 1e-3)
    if fp32_max_abs >= JAX_STREAM_BOUND or ratio > STREAM_BF16_RATIO:
        raise AssertionError(
            f"{name}: fp32 codec, streamed vs one-shot max-abs "
            f"{fp32_max_abs:.3e} (bound {JAX_STREAM_BOUND}); bf16 streamed "
            f"vs the fp32 one-shot decode rel-RMS {err_stream:.4f}, "
            f"{ratio:.3f}x the bf16 one-shot decode's "
            f"{err_one:.4f} (bound {STREAM_BF16_RATIO}x)")
    # playback from first audio: chunk i plays when it has arrived and the
    # one before it has played out
    secs = [c.audio.shape[1] / rate for c in chunks]
    play_end, stall = arrivals[0], 0.0
    for arrival, dur in zip(arrivals, secs):
        stall += max(0.0, arrival - play_end)
        play_end = max(play_end, arrival) + dur
    wall, audio_s = arrivals[-1], sum(secs)
    log(f"  request {name}: {wall * 1e3:.1f} ms wall, {audio_s:.2f} s audio; "
        f"launches {got}; fp32 codec (plain stacks), streamed vs one-shot: "
        f"max-abs {fp32_max_abs:.3e} (bound {JAX_STREAM_BOUND}), rel-RMS "
        f"{fp32_rel:.3e}; bf16 against the fp32 one-shot decode, rel-RMS: "
        f"streamed {err_stream:.4f}, one-shot {err_one:.4f}, "
        f"{ratio:.3f}x (bound {STREAM_BF16_RATIO}x); bf16 "
        f"streamed vs one-shot: max-abs {bf16_max_abs:.3e}, rel-RMS "
        f"{bf16_rel:.4f}")
    for c, arrival, cum in zip(chunks, arrivals, np.cumsum(secs)):
        log(f"    chunk {c.index} ({c.latent_end - c.latent_start} latents): "
            f"arrived {arrival * 1e3:.1f} ms, audio so far {cum:.3f} s")
    log(f"  request e: TTFA {arrivals[0] * 1e3:.1f} ms, streamed RTF "
        f"{audio_s / wall:.3f}x, playback stall {stall * 1e3:.1f} ms after "
        f"first audio; decode_ms per block {[round(v, 1) for v in decode_ms]}")
    return got


def incremental_check(models, lat, mask, ids, tmask) -> None:
    """The blockwise sampler at full width with the incremental latent
    prefix against the re-encode, on the same seeded noise (bf16 bound
    rel-RMS 1e-2), and a check that the prefix reaches the later blocks at
    all.  Depth reduced to 4 steps on blocks [40, 40, 80], so that the run
    stays within its time limit."""
    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.sampler.blockwise import (
        sample_blockwise_euler_cfg_independent_guidances as blockwise)
    dev = models.device
    blocks = [40, 40, 80]
    g = torch.Generator(device=dev).manual_seed(90)
    noises = [torch.randn((1, b, models.dit_cfg.latent_size), generator=g,
                          device=dev) for b in blocks]
    kw = dict(SAMPLER_DEFAULTS, num_steps=4)
    kw.pop("sequence_length")
    spk, smask = torch.from_numpy(lat).to(dev), torch.from_numpy(mask).to(dev)
    def run(noise, inc):
        return blockwise(models.dit, spk, smask, ids, tmask, block_sizes=blocks,
                         dtype=models.dtype, initial_noises=noise,
                         incremental_latent=inc, **kw)

    got = {inc: run(noises, inc) for inc in (True, False)}
    _, rel = errors(got[True], got[False])
    # the prefix is seen: a first block from half its noise moves the
    # later blocks (a prefix masked out everywhere would leave them)
    moved = run([noises[0] * 0.5] + noises[1:], False)
    _, effect = errors(moved[:, blocks[0]:], got[False][:, blocks[0]:])
    if rel > REL_RMS_BOUND or effect <= 1e-3:
        raise AssertionError(f"incremental vs re-encoded latent prefix: "
                             f"rel-RMS {rel:.3e} (bound {REL_RMS_BOUND}); "
                             f"the prefix moves later blocks by {effect:.3e}")
    log(f"  blockwise sampler, incremental vs re-encoded latent prefix "
        f"(blocks {blocks}, num_steps 4: depth reduced to keep the run "
        f"short): rel-RMS {rel:.3e} (bound {REL_RMS_BOUND}); a first block "
        f"from half its noise moves the later blocks by rel-RMS "
        f"{effect:.3e} (must exceed 1e-3)")


def kernel_entry(name, source, replaces, cases, main, launches, **extra):
    """One entry of the {"kernels": [...]} line: the main case's numbers,
    and the worst error over all cases."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in cases),
                rel_rms=max(r["rel_rms"] for r in cases),
                ms=main["ms"], kernel_ms=main["ms"], host_us=main["host_us"],
                plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shape=main["shape"], **extra)


def main(argv) -> int:
    t_start = time.perf_counter()
    import torch
    phase_device()
    phase_build()
    kernels_only = "--kernels-only" in argv
    # the main path runs before the kernels are timed: torch.profiler, which
    # times them, leaves tracing attached that slows the host-bound
    # sampler's wall time afterwards
    launches = None if kernels_only else phase_main_path()
    att, att8, rst, mm = phase_kernels()
    if kernels_only:
        # the kernels alone, to time two trees' kernels in one call
        print(json.dumps({"cases": dict(attention=att, attention_kv8=att8,
                                        res_stack=rst, int8_matmul=mm)}),
              flush=True)
        return 0
    rst_stream = next(r for r in rst if r["shape"] == "C=96 L=655360 "
                      "snake=sin2_poly history")
    kernels = [
        # GB=3, S=640, T=778: request b's shape; the int8 K/V form at
        # request d's, with its own numbers and launch count
        kernel_entry(
            "joint_attention", "echo_tts_torch/csrc/joint_attention.cu",
            "echo_tts_tpu/ops/pallas/joint_attention.py:53 (_kernel) and "
            ":105 (_flash_kernel)", att + att8, att[0],
            launches["joint_attention"] + launches["joint_attention_kv8"],
            launches_bf16=launches["joint_attention"],
            launches_kv8=launches["joint_attention_kv8"],
            kv8={k: att8[0][k] for k in ("shape", "ms", "host_us", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by",
                                         "max_abs_err", "rel_rms")}),
        # C=96 with the serving decoder's snake; launches count wrapper
        # calls, one per three-unit stack (three kernel launches each), of
        # the one-shot form and of the history form (request e); the
        # history form's main case is the last decoder block of a
        # 320-latent streamed block
        kernel_entry(
            "res_stack", "echo_tts_torch/csrc/res_stack.cu",
            "echo_tts_tpu/ops/pallas/res_stack.py:60 (_res_stack_kernel)",
            rst, rst[0], launches["res_stack"] + launches["res_stack_stream"],
            launches_oneshot=launches["res_stack"],
            launches_stream=launches["res_stack_stream"],
            unrolled_ms=rst[0]["unrolled_ms"],
            bound_share=rst[0]["bound_share"],
            stream={k: rst_stream[k] for k in (
                "shape", "ms", "host_us", "plain_ms", "unrolled_ms",
                "library_ms", "bound_ms", "bound_by", "bound_share",
                "max_abs_err", "rel_rms")}),
        # M=1920 (a CFG step), w1/w3 (2048 -> 5888); max_abs_err is the
        # fp32 output's
        kernel_entry(
            "int8_matmul", "echo_tts_torch/csrc/int8_matmul.cu",
            "echo_tts_tpu/ops/pallas/int8_matmul.py:44 (_kernel)", mm, mm[0],
            launches["int8_matmul"],
            max_abs_err_bf16=max(r["max_abs_err_bf16"] for r in mm),
            prepass_ms=mm[0]["prepass_ms"],
            bf16_matmul_ms=mm[0]["bf16_matmul_ms"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
