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
     re-encode, at reduced depth; then the serving layer: (f) the
     handler's one-shot job (a two-chunk text, voice.wav from a voices
     directory, seed 7), its chunks bit for bit sample_pipeline's with
     seeds 7 and 1007, again from the voice cache, and health_check; (g) a
     streaming job through the handler under ECHO_DIT_QUANT=int8; (h) one
     micro-batched pass of eight concurrent submits to MicroBatchServer
     (KV batch 8), each request's noise bit for bit its single draw and its
     latents within rel-RMS 1e-2 of the request run alone, with the
     batch's audio seconds per wall second; then the runnable entry points
     (echo_tts_torch/examples/, given phase 3's models): (p) generate.main
     with voice.wav, a preset and a seed, its WAV bit for bit
     sample_pipeline's audio; (q) streaming_demo.main --total-latents 640,
     its WAV bit for bit request (e)'s chunks; (r) soak_long_stream.main,
     one stream of 16 x 320 = 5120 latents (the largest schedule serving
     accepts) with its report and gates (tail/mid <= 1.5, memory_allocated
     growth <= 256 MB, 5120 x 2048 finite samples), kernel A's shapes
     recorded and the measured stream's launches exact; (s)
     tools/check_fullsize.check, the full-depth CFG forward in bf16 within
     rel-RMS 0.05 and max-abs 0.30 of fp32, the W8A8 forward beside it;
     then training at the published
     depth, seeded random weights: (i) train.loop.train at B = 2 on one
     batch of the DataConfig shapes, t and eps fixed, three steps in each
     remat mode (none, full, dots, dots_all, attn): kernel A's launches
     per step exact (24, or 48 where the recompute re-runs the forward),
     step ms, peak memory, each mode's gradients within rel-RMS 1e-2 of
     "none"'s, the first-step losses within 1e-3, the loss lower at step 3;
     kernel A's step against the plain version's and against the fp32
     step at the bf16 step's timestep (within GRAD_FP32_RATIO of the
     plain bf16 step's distance); one
     step at blockwise=True (the latent encoder decayed without a
     gradient); (j) write_shards on voice.wav (kernel B) feeding one step
     through iter_batches; (k) two distill steps, 8 student steps of 5
     teacher substeps, plain and quant-aware; (l) the student's bundle
     saved and loaded through serve.models.load_models bit for bit, then a
     handler job with few_step_sampler_params(8) in bf16 and under
     ECHO_DIT_QUANT=int8; (m) one DemoSession.generate_audio, bit for bit
     sample_pipeline's; then scale-out (echo_tts_torch/parallel/): (n)
     request (b) again at world size 1, through initialize_from_env (NCCL
     on localhost), global_mesh(tp=1), shard_models and place_request, its
     latents bit for bit (b)'s and 960 kernel A launches, then (b)'s inputs
     through the fp32 sampler (plain attention); (o) two ranks on the one
     card (torch.multiprocessing spawn, a gloo world: NCCL refuses two
     ranks on one device), each building the published DiT and its own
     unsharded references: SP tp=2 at 6400 latents, DP=2 on a B = 2
     request, TP=2 and W8A8 TP=2 forwards (kernel A at 8 heads; kernel C's
     given-scale instance in the row-parallel products), request (b)'s 40
     steps at TP=2 (held to the fp32 latents within TP_FP32_RATIO times
     (b)'s own distance), and a TP=2 and a DP=2 train step at
     TRAIN_DEPTH layers against the one-card step, every launch count
     exact (request_two_ranks says each gate);
  4. each kernel against its plain PyTorch version on the card at the main
     path's shapes (and at ragged shapes shorter than one tile): joint
     attention with bf16 and with int8 static K/V, at the streaming
     shapes (latent-prefix columns, part or a whole tile masked; request
     r's last block, T = 2208 with 1200 of 1280 latent columns valid) and over
     a KV batch of 2 and 8 (request h's, per-row speaker lengths masked),
     at request k's teacher (GB = 6 over a KV batch of 2) and request m's
     demo (GB = 3 and 1, 10 of 160 speaker columns valid) with T = 928,
     and under grad (the autograd Function's gradients against the plain
     version's; at request i's training shape too, and its forward under
     grad alone); the
     residual stack, one-shot (at batch 1 and, as request h decodes, 4)
     and in its history form at streamed block shapes (new history
     checked too, zero history bit-equal to the one-shot kernel); the W8A8 matmul (fp32 output within 1e-5 of the
     plain version, bf16 output rel-RMS); kernel A at a tensor-parallel
     rank's 8 and 4 heads and kernel C's given-scale instance at the
     row-parallel K-slices (its int32 sums equal to the plain version's);
     max-abs and rel-RMS error against
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
DEVICE = "cuda"             # the serving requests' ECHO_DEVICE
TEXT = ("The quick brown fox jumps over the lazy dog, then reads it a "
        "bedtime story.")
STREAM_TOTAL = 640          # request (e): growing_schedule(640)
GENERATE_PRESET, GENERATE_SEED = "Independent-High-CFG", 11   # request (p)
# request (r)'s last block: latent-prefix columns 5120 / 4, valid 4800 / 4;
# the soak's prompt fills every text column
SOAK_LATENT_COLUMNS, SOAK_LAST_VALID, SOAK_TEXT_VALID = 1280, 1200, 768
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
# request (f): two chunks under the handler's audio-aware chunking
HANDLER_TEXT = (
    "The lighthouse keeper climbed the spiral stairs at dusk and lit the "
    "great lamp for the ships. Far out beyond the reef a single fishing "
    "boat rocked gently on the calm and quiet swell.")
# request (h): one text per request of the micro-batch
BATCH_TEXTS = (
    "Good morning, and welcome to the station.",
    "The next train leaves from platform four.",
    "Please keep your belongings with you at all times.",
    "Tickets are available at the machines by the entrance.",
    "The weather today is mild with a light breeze.",
    "Thank you for calling, how can I help you?",
    "Your order has been shipped and will arrive soon.",
    "The meeting has been moved to three in the afternoon.")
LONG_TEXT = (
    "The lighthouse keeper climbed the spiral stairs every evening at "
    "dusk, counting the steps as his father had taught him, and lit the "
    "great lamp that swept the dark water for passing ships. "
    "Tonight the sea was calm, the air smelled of salt and rain, and far "
    "out beyond the reef a single fishing boat rocked gently on the swell, "
    "its lantern glowing like a small and stubborn star against the "
    "gathering night.")


# torch.profiler traces a timing takes before it reads CUDA events instead
TRACES = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int) -> dict:
    """One call of fn, after a warm-up: `ms`, its device time, the sum of
    the device intervals (kernels, copies, sets) that `reps` calls queue,
    as torch.profiler reads them, over reps; `by_name`, that sum split by
    kernel name; `host_us`, the host's microseconds to issue one call (the
    wall time of `reps` calls queued without a synchronise, over reps);
    `timer`, what read `ms`.

    Every call queues the same device work, so a whole trace holds each
    name's events a positive multiple of `reps` times.  The profiler now
    and then drops some of a kernel's events, which would read several
    times too fast, and a trace that does so is taken again.  After
    TRACES such traces `ms` is read with CUDA events instead: the device's
    elapsed time from before the first of `reps` calls to after the last,
    over reps.  That time holds the gaps between the calls' work too, so
    it is never below the profiler's sum; `by_name` is then empty."""
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
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, count = {}, {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                span = (ev.time_range.end - ev.time_range.start) / 1e3 / reps
                by_name[ev.name] = by_name.get(ev.name, 0.0) + span
                count[ev.name] = count.get(ev.name, 0) + 1
        short = {k[:60]: n for k, n in count.items() if n % reps}
        ms = sum(by_name.values())
        if ms > 0 and not short:
            return dict(ms=ms, by_name=by_name, host_us=host_us,
                        timer="profiler")
        log(f"  (torch.profiler: device time {ms:.4f} ms, events not a "
            f"multiple of {reps} calls: {short}; tracing again)")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    log(f"  (torch.profiler dropped device events in {TRACES} traces of "
        f"{reps} calls: {ms:.4f} ms per call read with CUDA events)")
    return dict(ms=ms, by_name={}, host_us=host_us, timer="cuda events")


def host_us_paired(fn_a, fn_b, reps: int = 50, rounds: int = 41) -> dict:
    """The host's microseconds to issue one call of fn_a and of fn_b:
    rounds of `reps` calls each, the two in turns (a, b, b, a, ...), each
    round ended by a synchronise.  `a_us` and `b_us` are the median round
    of each; `diff_us` the median of the rounds' differences b - a, with
    its quartiles in `diff_q_us`.  Turns keep a drift of the shared host's
    load out of the difference; the quartiles say whether it is resolved
    (both on one side of 0)."""
    import torch
    times = ([], [])
    for r in range(rounds):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            fn = (fn_a, fn_b)[i]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times[i].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    diff = np.subtract(times[1], times[0])
    return dict(a_us=float(np.median(times[0])),
                b_us=float(np.median(times[1])),
                diff_us=float(np.median(diff)),
                diff_q_us=[float(x) for x in np.percentile(diff, [25, 75])])


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


# launch counters: {name: (wrapper, attribute)}, reset just before a
# request and read just after it
def _reset(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _read(counters) -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def kernel_counters() -> dict:
    from echo_tts_torch.ops.int8_matmul import (int8_matmul_fused,
                                                int8_matmul_partial)
    from echo_tts_torch.ops.joint_attention import fused_joint_attention
    from echo_tts_torch.ops.res_stack import fused_res_stack
    return {"joint_attention": (fused_joint_attention, "launches"),
            "joint_attention_kv8": (fused_joint_attention, "launches_kv8"),
            "int8_matmul": (int8_matmul_fused, "launches"),
            "int8_matmul_partial": (int8_matmul_partial, "launches"),
            "res_stack": (fused_res_stack, "launches"),
            "res_stack_stream": (fused_res_stack, "launches_stream")}


def _want(attn=0, kv8=0, int8=0, res=0, res_stream=0, partial=0) -> dict:
    return {"joint_attention": attn, "joint_attention_kv8": kv8,
            "int8_matmul": int8, "int8_matmul_partial": partial,
            "res_stack": res, "res_stack_stream": res_stream}


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from echo_tts_torch.device import card_name
    card = card_name()
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
                   n_lat: int = 0, lat_valid: int = 0, b: int = 1,
                   spk_lens=None, under_grad: bool = False, h: int = 16,
                   n_text: int = 96):
    """Kernel A at one shape; kv8 stores the static K/V int8 (the port's
    quantize_kv_int8 of the same bf16 K/V) and passes their scales.  With
    n_lat, the static columns are [latent, text, speaker] as a streamed
    block after the first has them, the latent columns from lat_valid on
    masked in every row (positions at or past the block's start).  b is
    the static K/V batch (a micro-batch of b requests; GB = G * b rows,
    G-major); spk_lens gives each KV row's valid speaker columns (the rest
    masked, as a batch padded to one speaker bucket is).  under_grad:
    q, k_self, v_self and the static K/V require grad, so that the
    forward runs as training's does, through the autograd Function (its
    kernel launch counted; no backward here).  h: the heads (16, or a
    tensor-parallel rank's).  n_text: the valid text columns of the 768
    (96, a short prompt's bytes; 768, a prompt that fills them)."""
    import torch
    from echo_tts_torch.ops import joint_attention as ja
    from echo_tts_torch.ops import quant
    dh = 128
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, ks, vs = rnd(gb, s, h, dh), rnd(gb, s, h, dh), rnd(gb, s, h, dh)
    kt, vt = rnd(b, t, h, dh), rnd(b, t, h, dh)
    t_text = 768
    text = torch.zeros((t,), dtype=torch.bool, device=dev)
    text[n_lat:n_lat + min(n_text, t_text)] = True
    spk_cols = torch.zeros((t,), dtype=torch.bool, device=dev)
    spk_cols[n_lat + t_text:] = True
    lat = torch.zeros((t,), dtype=torch.bool, device=dev)
    lat[:lat_valid] = True
    rows = []
    g_branches = gb // b
    for g in range(g_branches):       # G-major: row g * b + i reads KV row i
        for i in range(b):
            spk = spk_cols.clone()
            if spk_lens is not None:
                spk[n_lat + t_text + spk_lens[i]:] = False
            cond = lat | text | spk
            # CFG branches blank whole segments
            rows.append([cond, lat | spk, lat | text][g] if g_branches == 3
                        else cond)
    mask = torch.stack(rows)
    col_scale = torch.where(spk_cols, 1.5, 1.0).float()
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
        if under_grad:
            for x in (q, ks, vs, kt, vt):
                x.requires_grad_()
        args = (q, ks, vs, kt, vt, mask, col_scale)

    before = ja.fused_joint_attention.launches
    out = ja.fused_joint_attention(*args, **kw)
    torch.cuda.synchronize()
    if under_grad and (out.grad_fn is None
                       or ja.fused_joint_attention.launches != before + 1):
        raise AssertionError("the forward under grad did not launch the "
                             "kernel once inside the autograd Function")
    with torch.no_grad():
        ref = ja.joint_attention_plain(*args, **kw)
    max_abs, rel = errors(out.detach(), ref)
    latent = f" latent {lat_valid}/{n_lat}" if n_lat else ""
    latent += f" B={b}" if b > 1 else ""
    latent += f" speaker columns {list(spk_lens)}" if spk_lens else ""
    latent += " under grad" if under_grad else ""
    latent += f" text {n_text}" if n_text != 96 else ""
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
                    .repeat(gb // b, 1, 1, 1)], 1).transpose(1, 2).contiguous()
    vb = torch.cat([vs, (vt * col_scale[None, :, None, None].to(vt.dtype))
                    .repeat(gb // b, 1, 1, 1)], 1).transpose(1, 2).contiguous()
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
               timer=kernel["timer"],
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
               bound_by=b_by, bound_share=b_ms / kernel_ms)
    log(f"  attention {res['shape']}: max_abs {max_abs:.3e} rel_rms {rel:.3e}"
        f" (bound {REL_RMS_BOUND}) kernel_ms {kernel_ms:.4f} host_us "
        f"{kernel['host_us']:.1f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by}), {100 * b_ms / kernel_ms:.1f} % of the bound")
    return res


def attention_backward_case(gb: int, s: int, t: int, seed: int, b: int = 1,
                            spk_lens=None, host_pairs: bool = True):
    """Kernel A under grad: the forward through the autograd Function that
    carries the kernel (its output the kernel's, its launch counted), the
    gradients of q, k_self, v_self and the static K/V from its backward,
    against autograd through joint_attention_plain on the same bf16
    inputs and the same output gradient (bound rel-RMS 1e-2).  Times one
    forward + backward: the Function's, the plain version's and SDPA's
    (yardstick).  Also the host microseconds of one call without grad, in
    turns: the wrapper (which launches the kernel directly), and the same
    launch through the Function, which a wrapper that always took it would
    pay.  With b > 1 (training's KV batch, GB = b, no CFG branches) the
    rows mask their text past 96 bytes and their speaker columns past
    spk_lens, and host_pairs=False skips the host count."""
    import torch
    import torch.nn.functional as F
    from echo_tts_torch.ops import joint_attention as ja
    h, dh = 16, 128
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    base = [rnd(gb, s, h, dh), rnd(gb, s, h, dh), rnd(gb, s, h, dh),
            rnd(b, t, h, dh), rnd(b, t, h, dh)]
    ct = rnd(gb, s, h, dh)
    mask = torch.ones((gb, t), dtype=torch.bool, device=dev)
    if b == 1:
        mask[1, :768] = False                   # uncond text
        mask[2, 768:] = False                   # uncond speaker
    else:
        mask[:, 96:768] = False                 # text padding
        for i, n in enumerate(spk_lens):
            mask[i, 768 + n:] = False           # speaker padding
    col_scale = torch.ones((t,), device=dev)
    col_scale[768:] = 1.5
    sm = dh ** -0.5
    names = ("q", "k_self", "v_self", "k_static", "v_static")

    def grads(fn):
        leaves = [x.detach().clone().requires_grad_() for x in base]
        out = fn(*leaves, mask, col_scale, sm_scale=sm)
        out.backward(ct)
        return out.detach(), [x.grad for x in leaves]

    before = ja.fused_joint_attention.launches
    out_k, g_k = grads(ja.fused_joint_attention)
    torch.cuda.synchronize()
    launched = ja.fused_joint_attention.launches - before
    out_p, g_p = grads(ja.joint_attention_plain)
    with torch.no_grad():
        out_nograd = ja.fused_joint_attention(*base, mask, col_scale,
                                              sm_scale=sm)
    name = f"joint attention backward GB={gb} S={s} T={t}"
    if launched != 1 or not torch.equal(out_k, out_nograd):
        raise AssertionError(f"{name}: the forward under grad launched the "
                             f"kernel {launched} times; its output equals the "
                             f"kernel's without grad: "
                             f"{torch.equal(out_k, out_nograd)}")
    errs = {n: errors(a, w) for n, a, w in zip(names, g_k, g_p)}
    errs["out"] = errors(out_k, out_p)
    worst = max(r for _, r in errs.values())
    if worst > REL_RMS_BOUND:
        raise AssertionError(f"{name}: rel-RMS {errs} > {REL_RMS_BOUND}")

    def fwd_bwd(fn):
        leaves = [x.detach().requires_grad_() for x in base]
        return lambda: fn(*leaves, mask, col_scale, sm_scale=sm).backward(ct)

    kernel = timed(fwd_bwd(ja.fused_joint_attention), 10)
    plain_ms = timed(fwd_bwd(ja.joint_attention_plain), 5)["ms"]
    # yardstick: SDPA forward + backward on [self | static], as in
    # attention_case
    kb = torch.cat([base[1], (base[3] * col_scale[None, :, None, None]
                              .to(torch.bfloat16)).repeat(gb // b, 1, 1, 1)],
                   1).transpose(1, 2).contiguous().requires_grad_()
    vb = torch.cat([base[2], (base[4] * col_scale[None, :, None, None]
                              .to(torch.bfloat16)).repeat(gb // b, 1, 1, 1)],
                   1).transpose(1, 2).contiguous().requires_grad_()
    qb = base[0].transpose(1, 2).contiguous().requires_grad_()
    am = torch.cat([torch.zeros((gb, s), device=dev),
                    torch.where(mask, 0.0, ja.MASK_VALUE)], 1)[:, None, None, :]
    am = am.to(torch.bfloat16)
    ctb = ct.transpose(1, 2).contiguous()
    library_ms = timed(lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=am, scale=sm).backward(ctb), 10)["ms"]
    # forward 2 matmuls (Q K^T, P V), backward 4 (dV, dP, dQ, dK; P's
    # recompute is not counted), each 2 * GB * H * S * (S + T) * Dh
    flops = 12.0 * gb * h * s * (s + t) * dh
    # q, k_self, v_self, the static K/V and the output gradient read once;
    # the output and the five gradients written once; mask, column scale
    nbytes = ((4 * gb * s * h * dh + 2 * b * t * h * dh) * 2 * 2
              + gb * t + t * 4)
    b_ms, b_by = bound(flops, nbytes)
    # what the autograd Function would add to a call without grad: the
    # launch alone (the wrapper's path without grad) against the launch
    # through the Function (its path under grad), paired in turns
    host = dict(a_us=None, b_us=None, diff_us=None, diff_q_us=[None, None])
    if host_pairs:
        with torch.no_grad():
            args = (*base, mask, col_scale)
            host = host_us_paired(
                lambda: ja._launch(*args, sm),
                lambda: ja._KernelWithPlainGrad.apply(ja._launch, sm, *args))
    res = dict(shape=f"GB={gb} S={s} T={t} H={h} Dh={dh}"
               + (f" B={b} speaker columns {list(spk_lens)}" if b > 1 else "")
               + " forward+backward",
               max_abs_err=max(a for a, _ in errs.values()), rel_rms=worst,
               rel_rms_by_tensor={k: v[1] for k, v in errs.items()},
               ms=kernel["ms"], host_us=kernel["host_us"],
               timer=kernel["timer"], plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
               bound_share=b_ms / kernel["ms"],
               host_us_no_grad_launch=host["a_us"],
               host_us_no_grad_function=host["b_us"],
               host_us_function_cost=host["diff_us"],
               host_us_function_cost_quartiles=host["diff_q_us"])
    log(f"  attention backward {res['shape']}: rel_rms by tensor "
        f"{ {k: f'{v[1]:.3e}' for k, v in errs.items()} } (bound "
        f"{REL_RMS_BOUND}); kernel forward + plain-recompute backward ms "
        f"{kernel['ms']:.4f} host_us {kernel['host_us']:.1f} plain_ms "
        f"{plain_ms:.4f} library_ms (SDPA fwd+bwd) {library_ms:.4f} bound_ms "
        f"{b_ms:.4f} ({b_by}), {100 * b_ms / kernel['ms']:.1f} % of the "
        f"bound" + ("" if not host_pairs else
                    f"; host_us per call without grad: launch "
                    f"{host['a_us']:.1f}, through the autograd Function "
                    f"{host['b_us']:.1f}, paired difference "
                    f"{host['diff_us']:.1f} (quartiles "
                    f"{host['diff_q_us'][0]:.1f}, {host['diff_q_us'][1]:.1f})"))
    return res


def res_stack_inputs(c: int, length: int, seed: int, batch: int = 1):
    """(rnd, x, args, weights): kernel B's inputs at one shape, bf16 on the
    card (x (batch, length, c)), and the generator-backed rnd(shape, std)
    that drew them."""
    import torch
    from echo_tts_torch.ops import res_stack as rs
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape, std):
        return (torch.randn(shape, generator=g, device=dev) * std).to(torch.bfloat16)

    x = rnd((batch, length, c), 0.5)
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


def res_stack_case(c: int, length: int, approx: bool, seed: int,
                   batch: int = 1):
    import torch
    from echo_tts_torch.models.dac.conv import residual_unit
    from echo_tts_torch.ops import res_stack as rs
    _, x, args, weights = res_stack_inputs(c, length, seed, batch)
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
        raise AssertionError(f"res stack C={c} L={length} approx={approx} "
                             f"batch {batch}: "
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
    flops = 3 * 2.0 * 8 * c * c * length * batch
    nbytes = 2 * batch * length * c * 2 + 3 * 8 * c * c * 2 + 3 * 4 * c * 2
    b_ms, b_by = bound(flops, nbytes)
    res = dict(shape=f"C={c} L={length} snake={'sin2_poly' if approx else 'exact'}"
               + (f" batch {batch}" if batch > 1 else ""),
               max_abs_err=max_abs, rel_rms=max(rel, rel_head), ms=kernel_ms,
               host_us=kernel["host_us"], timer=kernel["timer"],
               plain_ms=plain_ms, library_ms=None,
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
               ms=kernel["ms"], host_us=kernel["host_us"],
               timer=kernel["timer"], plain_ms=plain_ms,
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
    prepass_ms = (sum(v for k, v in kernel["by_name"].items()
                      if "quantize_rows" in k) if kernel["by_name"] else None)
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
               timer=kernel["timer"],
               plain_ms=plain_ms, library_ms=library_ms,
               bf16_matmul_ms=bf16_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"  {name}: fp32 max_abs {max_abs32:.3e} (bound {INT8_FP32_BOUND}) "
        f"bf16 max_abs {max_abs:.3e} rel_rms {rel:.3e} (bound "
        f"{REL_RMS_BOUND}); W8A8 vs bf16 matmul rel_rms {rel_bf16:.3e}; "
        f"kernel_ms {kernel_ms:.4f} (pre-pass "
        f"{'not measured' if prepass_ms is None else f'{prepass_ms:.4f}'}) host_us "
        f"{kernel['host_us']:.1f} plain_ms {plain_ms:.4f} _int_mm_ms "
        f"{library_ms:.4f} bf16_matmul_ms {bf16_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by})")
    return res


def int8_partial_case(m: int, k: int, n: int, seed: int):
    """Kernel C's row-parallel instance at one (M, K-slice, N): x bf16, its
    row scale taken over the whole K (this slice and a second one of the
    same width), the weight's slice quantized by the port's
    quantize_weight_int8.  Its int32 sums must equal the plain version's
    exactly."""
    import torch
    from echo_tts_torch.ops import int8_matmul as im
    from echo_tts_torch.ops import quant
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    other = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=g, device=dev)
         * (2 * k) ** -0.5).to(torch.bfloat16)
    w8, _ = quant.quantize_weight_int8(w)
    amax = torch.maximum(x.float().abs().amax(-1), other.float().abs().amax(-1))
    xs = amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)
    out = im.int8_matmul_partial(x, w8, xs)
    torch.cuda.synchronize()
    ref = im.int8_matmul_partial_plain(x, w8, xs)
    if out.dtype != torch.int32 or not torch.equal(out, ref):
        raise AssertionError(f"int8_matmul_partial M={m} K={k} N={n}: int32 "
                             f"sums differ from the plain version's by up to "
                             f"{int((out.long() - ref.long()).abs().max())}")
    kernel = timed(lambda: im.int8_matmul_partial(x, w8, xs), 50)
    prepass_ms = (sum(v for name, v in kernel["by_name"].items()
                      if "quantize_rows" in name) if kernel["by_name"] else None)
    plain_ms = timed(lambda: im.int8_matmul_partial_plain(x, w8, xs), 5)["ms"]
    # yardstick only: the library's int8 product on pre-quantized operands
    xq = torch.clamp(torch.round(x.float() / xs[:, None]), -127, 127).to(
        torch.int8)
    library_ms = timed(lambda: torch._int_mm(xq, w8.t()), 50)["ms"]
    # x bf16, w int8 and the row scales read once; int32 sums written once
    nbytes = m * k * 2 + n * k + m * 4 + m * n * 4
    b_ms, b_by = bound(2.0 * m * k * n, nbytes, PEAK_INT8_OPS)
    res = dict(shape=f"M={m} K={k} N={n} given scale, int32 out",
               max_abs_err=0.0, rel_rms=0.0, ms=kernel["ms"],
               prepass_ms=prepass_ms, host_us=kernel["host_us"],
               timer=kernel["timer"], plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
               bound_share=b_ms / kernel["ms"])
    log(f"  int8_matmul_partial {res['shape']}: int32 equal to plain; "
        f"kernel_ms {kernel['ms']:.4f} (pre-pass "
        f"{'not measured' if prepass_ms is None else f'{prepass_ms:.4f}'}) "
        f"host_us {kernel['host_us']:.1f} plain_ms {plain_ms:.4f} _int_mm_ms "
        f"{library_ms:.4f} bound_ms {b_ms:.4f} ({b_by}), "
        f"{100 * b_ms / kernel['ms']:.1f} % of the bound")
    return res


def scale_out_cases():
    """Requests (n) and (o)'s kernel shapes: kernel A at request (b)'s
    CFG step with a tensor-parallel rank's heads (8 at tp = 2, 4 at tp =
    4), and kernel C's row-parallel instance at wo's and w2's K-slices at
    tp = 2 on a CFG step (M = 1920; K = 1024 and 2944 -> N = 2048)."""
    return ([attention_case(3, 640, 778, seed=130, h=8),
             attention_case(3, 640, 778, seed=131, h=4)],
            [int8_partial_case(1920, 1024, 2048, seed=132),
             int8_partial_case(1920, 2944, 2048, seed=133)])


def training_cases():
    """Kernel A at request (i)'s shapes: B = 2 (GB = 2, no CFG branches),
    S = 640, T = 768 text + 160 speaker columns, the second row's speaker
    valid for 75 (300 latents): the forward under grad, and the forward
    with the plain recompute's backward."""
    return (attention_case(2, 640, 928, seed=120, b=2, spk_lens=[160, 75],
                           under_grad=True),
            attention_backward_case(2, 640, 928, seed=121, b=2,
                                    spk_lens=[160, 75], host_pairs=False))


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
    # request (r)'s last block: the block of 320 at 4800 in a 5120-latent
    # stream, T = 1280 latent + 768 text + 160 speaker columns with 1200
    # latent and all 768 text columns valid; GB = 3 on CFG steps, 1 else
    att += [attention_case(gb, 320, SOAK_LATENT_COLUMNS + 768 + 160,
                           seed=130 + gb, n_lat=SOAK_LATENT_COLUMNS,
                           lat_valid=SOAK_LAST_VALID, n_text=SOAK_TEXT_VALID)
            for gb in (3, 1)]
    # micro-batched passes (request h): a KV batch of B = 2 requests (GB = 6
    # on CFG steps) and of B = 8 (GB = 24 on CFG steps, 8 else), the eight
    # rows' speakers padded to one bucket with their own lengths masked
    spk_lens = [10, 8, 4, 0, 10, 6, 2, 10]
    att_batch = [attention_case(6, 640, 778, seed=100, b=2),
                 attention_case(24, 640, 778, seed=101, b=8, spk_lens=spk_lens),
                 attention_case(8, 640, 778, seed=102, b=8, spk_lens=spk_lens)]
    att += att_batch
    # request (k)'s teacher (GB = 6: three CFG branches over the KV batch
    # of 2, the speakers padded to 160 patches, 160 and 75 valid) and
    # request (m)'s demo (GB = 3 on CFG steps, 1 else; the speaker padded
    # to the 640-latent bucket with 10 of its 160 patches valid, so that
    # the last static tiles are masked in every row), at T = 768 + 160
    att += [attention_case(6, 640, 928, seed=122, b=2, spk_lens=[160, 75]),
            attention_case(3, 640, 928, seed=123, spk_lens=[10]),
            attention_case(1, 640, 928, seed=124, spk_lens=[10])]
    # int8 static K/V at request (d)'s shapes (GB=3 and 1, T=778) and at
    # the longest static K/V; and over a KV batch of 8
    att8 = [attention_case(gb, 640, t, seed=30 + i, kv8=True)
            for i, (gb, t) in enumerate([(3, 778), (1, 778), (3, 2368)])]
    att8.append(attention_case(24, 640, 778, seed=103, kv8=True, b=8,
                               spk_lens=spk_lens))
    # kernel A under grad (the autograd Function, backward by recompute)
    att_bwd = attention_backward_case(3, 640, 778, seed=104)
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
    # request (h)'s decode slices: batch 4 at the decoder's last block
    # (C = 96) and at its first kernel width (C = 384)
    rst += [res_stack_case(c, length, True, seed=110 + i, batch=4)
            for i, (c, length) in enumerate([(96, 1310720), (384, 163840)])]
    # the history form at the decoder's shapes for blocks of 40 and 320
    # latents (L = 256, 1024, 2048 frames a latent at C = 384, 192, 96),
    # with sin2_poly, and an encoder-side shape (C = 64) with exact sin
    rst += [res_stack_history_case(c, length, approx, seed=80 + i)
            for i, (c, length, approx) in enumerate(
                [(384, 10240, True), (192, 40960, True), (96, 81920, True),
                 (384, 81920, True), (192, 327680, True), (96, 655360, True),
                 (64, 2048, False)])]
    return att, att8, att_bwd, rst, mm


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def phase_main_path(card: str):
    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.ops import quant
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
    # request (b)'s sampler inputs and latents, which requests (n) and (o)
    # run again through the scale-out layer
    req_b = {}

    def recording_b(models_, spk, smask, ids, tmask, seed):
        out = timed_sample_fn(models_, spk, smask, ids, tmask, seed)
        req_b.update(spk=spk, smask=smask, ids=ids, tmask=tmask, seed=seed,
                     latents=out.clone())
        return out

    pl.dsp.crop_audio_to_flattening_point = recording_crop
    pl.ae_decode = timing(decode, "decode")
    # (name, run, sampler calls, encoded speaker chunks, int8 modes)
    requests = [
        ("a: sample_pipeline, no speaker", lambda: pl.sample_pipeline(
            models, timed_sample_fn, TEXT, None, 0), 1, 0, False),
        ("b: sample_pipeline, voice.wav", lambda: pl.sample_pipeline(
            models, recording_b, TEXT, voice, 1), 1, n_voice_chunks, False),
        ("c: sample_pipeline_chunked, 2 chunks, voice.wav",
         lambda: pl.sample_pipeline_chunked(
             models, timed_sample_fn, LONG_TEXT, voice, 2), 2, n_voice_chunks,
         False),
        ("d: sample_pipeline, voice.wav, W8A8 DiT + int8 K/V",
         lambda: pl.sample_pipeline(
             qmodels, timed_sample_fn_q, TEXT, voice, 1), 1, n_voice_chunks,
         True),
    ]
    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)
    request_stats = {}
    try:
        for name, run, n_samples, n_enc, int8_modes in requests:
            _reset(counters)
            n_dec = len(decoded)
            torch.cuda.synchronize()
            t = time.perf_counter()
            audio, _ = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = _read(counters)
            for k, v in got.items():
                launches[k] += v
            attn = n_layers * n_steps * n_samples
            want = {"joint_attention": 0 if int8_modes else attn,
                    "joint_attention_kv8": attn if int8_modes else 0,
                    "int8_matmul": n_int8_linears * attn if int8_modes else 0,
                    "int8_matmul_partial": 0,
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

    got, stream_audio = request_stream(models, voice, counters, n_voice_chunks)
    for k, v in got.items():
        launches[k] += v
    incremental_check(models, lat, mask, ids_t, tmask_t)
    del qmodels
    serve_models.clear_models()

    # the serving layer: (f) the handler's one-shot job, (g) a W8A8
    # streaming job, (h) a micro-batched pass
    import shutil
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(os.path.join(work, "voices"))
        shutil.copy(VOICE, os.path.join(work, "voices", "voice.wav"))
        for got in (request_handler(counters, work, n_layers, n_voice_chunks),
                    request_stream_w8a8(counters, work, n_layers, spl,
                                        n_voice_chunks),
                    request_batch(models, counters, card)):
            for k, v in got.items():
                launches[k] += v

    # the runnable entry points: (p) generate, (q) streaming_demo, (r) the
    # long-stream soak, (s) the full-depth bf16 forward against fp32
    for got in (request_generate(models, counters, n_layers, n_voice_chunks),
                request_stream_demo(models, counters, stream_audio, n_layers,
                                    n_voice_chunks),
                request_soak(models, counters, card),
                request_fullsize(models, counters, n_layers, n_int8_linears)):
        for k, v in got.items():
            launches[k] += v
    return launches, req_b


def request_stream(models, voice, counters, n_voice_chunks: int) -> tuple:
    """Request (e): stream_synthesize on the growing schedule of
    STREAM_TOTAL latents with voice.wav.  Checks the chunks, the launch
    counts (24 x 40 attention per block, kernel B's history form three
    times per block, its one-shot form three times per encoded speaker
    chunk) and the concatenated audio against the one-shot ae_decode of
    the same latents (see JAX_STREAM_BOUND and STREAM_BF16_RATIO); prints
    each chunk's arrival on the host clock, the time to first audio, the
    streamed RTF and the playback stall of a listener who starts at first
    audio.  Returns the launch counts and the chunks' audio concatenated
    (1, samples)."""
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

    _reset(counters)
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
    got = _read(counters)
    n = len(schedule)
    want = {"joint_attention": cfg.num_layers * SAMPLER_DEFAULTS["num_steps"] * n,
            "joint_attention_kv8": 0, "int8_matmul": 0,
            "int8_matmul_partial": 0,
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
    return got, streamed.numpy()


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


def request_handler(counters, work: str, n_layers: int,
                    n_voice_chunks: int) -> dict:
    """Request (f): the serving handler's one-shot job, a two-chunk text
    with voice.wav from a voices directory, boundary_mode "normalize",
    seed 7, at the published width (handler.handler with _allow_random:
    serve.models.load_models builds the seeded random bundle).  Checks the
    envelope, the launch counts (2 x 960 kernel A; kernel B: one voice
    encode, 3 calls, and 2 decodes, 6), each chunk's audio bit for bit
    against sample_pipeline on the same models with seeds 7 and 1007 and
    the cached voice latent; a second identical job (the voice cache: no
    encode launches); and health_check.  Returns the launch counts."""
    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.pipeline import audio_io, pipeline as pl
    from echo_tts_torch.serve import handler as th
    from echo_tts_torch.serve import models as serve_models
    from echo_tts_torch.serve.config import load_config

    cfg = load_config({"AUDIO_VOICES_DIR": os.path.join(work, "voices"),
                       "OUTPUT_AUDIO_DIR": os.path.join(work, "out"),
                       "HF_TOKEN": "unused", "ECHO_DEVICE": DEVICE})
    serve_models.clear_models()
    job = {"input": {"text": HANDLER_TEXT, "speaker_voice": "voice.wav",
                     "boundary_mode": "normalize", "seed": 7,
                     "_allow_random": True}}
    chunk_runs = []
    run_pipeline = th.sample_pipeline

    def recording_pipeline(models, fn, chunk, spk, rng_seed, **kw):
        audio, text = run_pipeline(models, fn, chunk, spk, rng_seed, **kw)
        chunk_runs.append((chunk, rng_seed, audio))
        return audio, text

    n_steps = SAMPLER_DEFAULTS["num_steps"]
    th.sample_pipeline = recording_pipeline
    total = dict.fromkeys(counters, 0)
    try:
        for attempt, want in (("first", _want(attn=2 * n_layers * n_steps,
                                              res=3 * n_voice_chunks + 2 * 3)),
                              ("cached voice", _want(attn=2 * n_layers * n_steps,
                                                     res=2 * 3))):
            _reset(counters)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = th.handler(job, cfg=cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = _read(counters)
            for k, v in got.items():
                total[k] += v
            name = f"f: handler one-shot, {attempt} job"
            if out.get("status") != "success":
                raise AssertionError(f"{name}: {out.get('error_type')}: "
                                     f"{out.get('error')}\n"
                                     f"{out.get('traceback')}")
            if got != want:
                raise AssertionError(f"{name}: launches {got}, want {want}")
            md = out["metadata"]
            stages = md["stage_timings"]
            if (md["num_chunks"] != 2 or md["seed"] != 7
                    or md["device"] != DEVICE
                    or stages["synthesis"]["calls"] != 2
                    or not {"model_load", "voice_encode", "synthesis",
                            "host_dsp", "encode_upload"} <= set(stages)
                    or not os.path.isfile(out["local_path"])):
                raise AssertionError(f"{name}: envelope {out}")
            if out["codec"] == "wav":
                audio, sr = audio_io.read_wav(out["local_path"])
                if (sr != 44100 or audio.shape[1] == 0
                        or not np.isfinite(audio).all()):
                    raise AssertionError(f"{name}: WAV {audio.shape} {sr}")
            log(f"  request {name}: {wall * 1e3:.1f} ms wall, "
                f"{md['duration_seconds']} s audio, envelope rtf {md['rtf']}; "
                f"launches {got}; codec {out['codec']}; stage_timings "
                f"{ {k: v['seconds'] for k, v in stages.items()} }")
    finally:
        th.sample_pipeline = run_pipeline
    hmodels = serve_models.load_models(None, allow_random=True)
    lat, mask, _ = th.get_voice_latent(
        hmodels, os.path.join(cfg.voices_dir, "voice.wav"))
    sample_fn, _ = th.build_sample_fn()
    for chunk, seed, audio in chunk_runs[:2]:
        want, _ = pl.sample_pipeline(hmodels, sample_fn, chunk, None, seed,
                                     speaker_latent=lat, speaker_mask=mask)
        if not np.array_equal(audio, want):
            raise AssertionError(
                f"f: chunk of seed {seed}: handler audio {audio.shape} is not "
                f"sample_pipeline's {want.shape} bit for bit (max-abs "
                f"{float(np.abs(audio - want).max()) if audio.shape == want.shape else 'n/a'})")
    seeds = [seed for _, seed, _ in chunk_runs]
    if seeds != [7, 1007, 7, 1007]:
        raise AssertionError(f"f: chunk seeds {seeds}")
    health = th.health_check(cfg)
    if (health["device"]["platform"] != DEVICE or not health["models_loaded"]
            or health["dit_quant"] != "none"):
        raise AssertionError(f"f: health_check {health}")
    log(f"  request f: chunks (seeds {seeds[:2]}) equal sample_pipeline's bit "
        f"for bit; health_check device {health['device']}, models_loaded "
        f"{health['models_loaded']}, dit_quant {health['dit_quant']}")
    return total


def request_stream_w8a8(counters, work: str, n_layers: int, spl: int,
                        n_voice_chunks: int) -> dict:
    """Request (g): a streaming job through the handler under
    ECHO_DIT_QUANT=int8, after clear_models(): chunk_sizes [40, 80] with
    voice.wav.  Checks the block events, the final envelope and the
    launch counts (kernel A 24 x 40 per block over bf16 static K/V, kernel
    C 8 per attention, kernel B 3 one-shot calls for the voice encode and
    3 history-form calls per block).  Returns the launch counts."""
    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.ops.quant import DIT_BLOCK_QUANT_KEYS
    from echo_tts_torch.serve import handler as th
    from echo_tts_torch.serve import models as serve_models
    from echo_tts_torch.serve.config import load_config

    cfg = load_config({"AUDIO_VOICES_DIR": os.path.join(work, "voices"),
                       "OUTPUT_AUDIO_DIR": os.path.join(work, "out"),
                       "HF_TOKEN": "unused", "ECHO_DEVICE": DEVICE})
    schedule = [40, 80]
    saved = os.environ.get("ECHO_DIT_QUANT")
    os.environ["ECHO_DIT_QUANT"] = "int8"
    events, arrivals = [], []
    try:
        serve_models.clear_models()
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()

        def on_block(event):
            arrivals.append(time.perf_counter() - t0)
            events.append(event)

        out = th.handler({"input": {
            "text": TEXT, "stream": True, "chunk_size": 40,
            "chunk_sizes": schedule, "speaker_voice": "voice.wav", "seed": 5,
            "_allow_random": True}}, cfg=cfg, on_block=on_block)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read(counters)
        quant = serve_models.served_quant_mode()
    finally:
        if saved is None:
            os.environ.pop("ECHO_DIT_QUANT")
        else:
            os.environ["ECHO_DIT_QUANT"] = saved
        serve_models.clear_models()
    name = f"g: handler stream job, ECHO_DIT_QUANT=int8, chunk_sizes={schedule}"
    if out.get("status") != "success":
        raise AssertionError(f"{name}: {out.get('error_type')}: "
                             f"{out.get('error')}\n{out.get('traceback')}")
    attn = n_layers * SAMPLER_DEFAULTS["num_steps"] * len(schedule)
    want = _want(attn=attn, int8=len(DIT_BLOCK_QUANT_KEYS) * attn,
                 res=3 * n_voice_chunks, res_stream=3 * len(schedule))
    if got != want or quant != "int8":
        raise AssertionError(f"{name}: launches {got}, want {want}; served "
                             f"quant mode {quant}")
    spans = [(e["index"], e["latent_start"], e["latent_end"], e["is_last"])
             for e in events]
    if (spans != [(0, 0, 40, False), (1, 40, 120, True)]
            or not all(os.path.isfile(e["local_path"]) for e in events)
            or [e["duration_seconds"] for e in events]
            != [round(n * spl / th.SAMPLE_RATE, 3) for n in schedule]
            or out["metadata"]["num_blocks"] != 2 or len(out["blocks"]) != 2
            or not os.path.isfile(out["local_path"])
            or out["metadata"]["device"] != DEVICE):
        raise AssertionError(f"{name}: events {spans}, envelope {out}")
    log(f"  request {name}: {wall * 1e3:.1f} ms wall (model load and "
        f"quantization included); launches {got}; blocks "
        f"{[(e['latent_start'], e['latent_end']) for e in events]} arrived "
        f"{[round(a * 1e3, 1) for a in arrivals]} ms, first_block_seconds "
        f"{out['metadata']['first_block_seconds']}, envelope rtf "
        f"{out['metadata']['rtf']}")
    return got


def request_batch(models, counters, card: str) -> dict:
    """Request (h): eight concurrent submits to MicroBatchServer(max_batch=8)
    with the same sampler parameters, four with voice.wav's cached latent
    and four without, seeds including a negative one and ones past 2**32.
    Checks that one batch pass ran (960 kernel A launches, 480 at GB = 24
    and 480 at GB = 8 over a KV batch of 8; 2 x 3 kernel B decode calls at
    batch 4), that each request's starting noise is its single-request
    draw bit for bit, and that its latents are within rel-RMS 1e-2 of the
    same request run alone through sample_pipeline.  Prints the batch's
    wall time and audio seconds per wall second.  Returns the launch
    counts."""
    import collections
    import threading

    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.models.dac import dac as tdac
    from echo_tts_torch.pipeline import pipeline as pl
    from echo_tts_torch.serve import batcher as sb
    from echo_tts_torch.serve import handler as th
    from echo_tts_torch.sampler.euler import build_step_plan
    from echo_tts_torch.serve import server as server_mod
    from echo_tts_torch.serve.server import MicroBatchServer

    lat, mask, bucket = th.get_voice_latent(models, VOICE)
    seeds = [11, -3, 2 ** 32 + 5, 4242, 7, -(2 ** 40), 2 ** 33 + 1, 99]
    reqs = [sb.BatchRequest(text, seed,
                            speaker_latent=lat if i < 4 else None,
                            speaker_mask=mask if i < 4 else None,
                            request_id=f"h{i}")
            for i, (text, seed) in enumerate(zip(BATCH_TEXTS, seeds))]
    params = dict(SAMPLER_DEFAULTS)
    sampled, attn_rows, res_rows = [], collections.Counter(), []
    order = []      # the requests in the batch's row order (arrival order)
    run_pass = server_mod.run_batch
    run_sampler = sb.sample_euler_cfg_independent_guidances
    run_attention, run_res_stack = tdit.fused_joint_attention, tdac.fused_res_stack

    def recording_sampler(*a, **k):
        out = run_sampler(*a, **k)
        sampled.append((k["initial_noise"].clone(), out.clone()))
        return out

    def recording_pass(models_, batch, *a, **k):
        order.append([r.request_id for r in batch])
        return run_pass(models_, batch, *a, **k)

    def recording_attention(q, *a, **k):
        attn_rows[(q.shape[0], a[2].shape[0])] += 1
        return run_attention(q, *a, **k)

    def recording_res_stack(x, *a, **k):
        res_rows.append(x.shape[0])
        return run_res_stack(x, *a, **k)

    server = MicroBatchServer(models, max_batch=8, max_wait_s=0.5)
    barrier = threading.Barrier(len(reqs))
    futures = [None] * len(reqs)

    def submit(i):
        barrier.wait()
        futures[i] = server.submit(reqs[i], params)

    server_mod.run_batch = recording_pass
    sb.sample_euler_cfg_independent_guidances = recording_sampler
    tdit.fused_joint_attention = recording_attention
    tdac.fused_res_stack = recording_res_stack
    try:
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(reqs))]
        for th_ in threads:
            th_.start()
        for th_ in threads:
            th_.join()
        results = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read(counters)
    finally:
        server_mod.run_batch = run_pass
        sb.sample_euler_cfg_independent_guidances = run_sampler
        tdit.fused_joint_attention = run_attention
        tdac.fused_res_stack = run_res_stack
        server.shutdown()
    stats = server.stats()
    n_layers, n_steps = models.dit_cfg.num_layers, SAMPLER_DEFAULTS["num_steps"]
    want = _want(attn=n_layers * n_steps, res=2 * 3)
    plan = build_step_plan(n_steps, params["cfg_min_t"], params["cfg_max_t"],
                           None, None, None, None)
    n_cfg = int(plan.has_cfg.sum())
    want_rows = {(24, 8): n_layers * n_cfg, (8, 8): n_layers * (n_steps - n_cfg)}
    name = "h: MicroBatchServer(max_batch=8), 8 concurrent submits"
    if (got != want or dict(attn_rows) != want_rows or res_rows != [4] * 6
            or stats["batches"] != 1 or stats["completed"] != 8
            or len(sampled) != 1 or len(order) != 1):
        raise AssertionError(
            f"{name}: launches {got}, want {want}; attention (GB, B) "
            f"{dict(attn_rows)}, want {want_rows}; residual-stack batches "
            f"{res_rows}; server {stats}; sampler passes {len(sampled)}")
    if [r.request_id for r in results] != [r.request_id for r in reqs]:
        raise AssertionError(f"{name}: results {[r.request_id for r in results]}")
    # row j of the pass is request order[0][j]; put them in request order
    rows = [order[0].index(r.request_id) for r in reqs]
    noise, latents = (x[rows] for x in sampled[0])

    # each request alone, through sample_pipeline with the handler's
    # sample_fn; the noise that euler_sample_fn draws is recorded
    drawn, singles = [], []
    real_randn = torch.randn

    def recording_randn(*a, **k):
        out = real_randn(*a, **k)
        if k.get("generator") is not None:
            drawn.append(out.clone())
        return out

    sample_fn, _ = th.build_sample_fn(params)

    def recording_fn(*a):
        out = sample_fn(*a)
        singles.append(out.clone())
        return out

    torch.randn = recording_randn
    try:
        for r in reqs:
            pl.sample_pipeline(models, recording_fn, r.text, None, r.seed,
                               speaker_latent=r.speaker_latent,
                               speaker_mask=r.speaker_mask)
    finally:
        torch.randn = real_randn
    bit_equal = [torch.equal(noise[i:i + 1], drawn[i]) for i in range(8)]
    rels = [errors(latents[i:i + 1], singles[i])[1] for i in range(8)]
    worst = int(np.argmax(rels))
    if not all(bit_equal) or max(rels) > REL_RMS_BOUND:
        raise AssertionError(
            f"{name}: noise bit-equal to the single draws {bit_equal}; "
            f"latents vs single runs rel-RMS {[f'{r:.3e}' for r in rels]} "
            f"(bound {REL_RMS_BOUND})")
    audio_s = sum(r.audio.shape[1] for r in results) / th.SAMPLE_RATE
    for r in results:
        if not np.isfinite(r.audio).all() or r.audio.shape[1] == 0:
            raise AssertionError(f"{name}: {r.request_id} audio {r.audio.shape}")
    log(f"  request {name}: one pass, launches {got}, attention (GB, B) "
        f"{dict(attn_rows)}, residual-stack batches {res_rows}; noise "
        f"bit-equal to each single draw: {all(bit_equal)} (seeds {seeds}); "
        f"latents vs each request alone, rel-RMS "
        f"{[f'{r:.3e}' for r in rels]}, worst {rels[worst]:.3e} (request "
        f"h{worst}, seed {seeds[worst]}, {'voice' if worst < 4 else 'no voice'}"
        f"; bound {REL_RMS_BOUND})")
    log(f"  request h: batch wall {wall * 1e3:.1f} ms for {audio_s:.2f} s of "
        f"audio: {audio_s / wall:.3f} audio seconds per wall second "
        f"(information for throughput_rtf_b8; {card}); server {stats}")
    return got


# ---------------------------------------------------------------------------
# phase 3, continued: the runnable entry points
# ---------------------------------------------------------------------------

def _same_wav(path: str, audio, rate: int) -> bool:
    """Whether the WAV at path holds exactly `audio` as write_wav writes it."""
    from echo_tts_torch.pipeline import audio_io
    want = path + ".want.wav"
    audio_io.write_wav(want, audio, rate)
    with open(path, "rb") as a, open(want, "rb") as b:
        return a.read() == b.read()


def request_generate(models, counters, n_layers: int,
                     n_voice_chunks: int) -> dict:
    """Request (p): examples/generate.main with --random-weights, given
    phase 3's models: TEXT, voice.wav, the preset GENERATE_PRESET, seed
    GENERATE_SEED.  Its WAV holds exactly sample_pipeline's audio at that
    seed and preset (the bytes write_wav gives it), that audio finite and
    not silent; kernel A 24 x 40, kernel B 3 (the decode) and 3 per voice
    chunk.  Returns the launch counts."""
    import tempfile

    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.examples import generate
    from echo_tts_torch.pipeline import audio_io, pipeline as pl
    from echo_tts_torch.serve.handler import build_sample_fn

    name = (f"p: examples.generate --random-weights --voice voice.wav "
            f"--preset {GENERATE_PRESET} --seed {GENERATE_SEED}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.wav")
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = generate.main(["--random-weights", "--text", TEXT, "--voice",
                            VOICE, "--preset", GENERATE_PRESET, "--seed",
                            str(GENERATE_SEED), "--out", out], models=models)
        wall = time.perf_counter() - t0
        got = _read(counters)
        sample_fn, _ = build_sample_fn(None, preset=GENERATE_PRESET)
        want, _ = pl.sample_pipeline(models, sample_fn, TEXT,
                                     audio_io.load_audio(VOICE), GENERATE_SEED)
        rate = models.dac_cfg.sample_rate
        wav, sr = audio_io.read_wav(out)
        same = _same_wav(out, want, rate)
    n_attn = n_layers * SAMPLER_DEFAULTS["num_steps"]
    if got != _want(attn=n_attn, res=3 + 3 * n_voice_chunks):
        raise AssertionError(f"{name}: launches {got}")
    if (rc != 0 or not same or sr != rate or wav.shape != want.shape
            or not np.isfinite(want).all() or float(np.abs(want).max()) <= 1e-4):
        raise AssertionError(f"{name}: exit {rc}; the WAV ({wav.shape}, "
                             f"{sr} Hz) holds sample_pipeline's audio "
                             f"{want.shape}: {same}")
    log(f"  request {name}: {wall * 1e3:.1f} ms wall (the WAV written), "
        f"{want.shape[1] / rate:.2f} s audio; the WAV is sample_pipeline's "
        f"audio at the same seed and preset, bit for bit; launches {got}")
    return got


def request_stream_demo(models, counters, stream_audio, n_layers: int,
                        n_voice_chunks: int) -> dict:
    """Request (q): examples/streaming_demo.main --total-latents
    STREAM_TOTAL with request (e)'s text, voice and seed: its WAV holds
    exactly (e)'s chunks concatenated; launches as (e)'s.  Returns the
    launch counts."""
    import tempfile

    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS, growing_schedule
    from echo_tts_torch.examples import streaming_demo

    name = (f"q: examples.streaming_demo --total-latents {STREAM_TOTAL} "
            f"--voice voice.wav --seed 5")
    n_blocks = len(growing_schedule(STREAM_TOTAL))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "stream.wav")
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = streaming_demo.main(["--text", TEXT, "--voice", VOICE,
                                  "--total-latents",
                                  str(STREAM_TOTAL), "--seed", "5", "--out",
                                  out], models=models)
        wall = time.perf_counter() - t0
        got = _read(counters)
        same = _same_wav(out, stream_audio, models.dac_cfg.sample_rate)
    want = _want(attn=n_layers * SAMPLER_DEFAULTS["num_steps"] * n_blocks,
                 res=3 * n_voice_chunks, res_stream=3 * n_blocks)
    if got != want:
        raise AssertionError(f"{name}: launches {got}, want {want}")
    if rc != 0 or not same:
        raise AssertionError(f"{name}: exit {rc}; the WAV holds request "
                             f"(e)'s chunks: {same}")
    log(f"  request {name}: {wall * 1e3:.1f} ms wall; the WAV is request "
        f"(e)'s chunks concatenated, bit for bit; launches {got}")
    return got


def request_soak(models, counters, card: str) -> dict:
    """Request (r): examples/soak_long_stream.main at its full schedule (16
    blocks of 320 latents, 5120, the largest that serving accepts), given
    phase 3's models.  Its report is printed and every gate holds: tail/mid
    <= 1.5, memory_allocated growth <= 256 MB, 5120 x 2048 finite samples.
    The measured stream's launches are exact (kernel A 24 x 40 x 16 =
    15360; kernel B's history form 3 a block, 48; its one-shot form 0, the
    speaker given as latents), and so are the whole call's (its warm pass
    of WARM_BLOCKS blocks too).  Kernel A's (GB, S, T) are recorded: the
    blocks after the first read T = SOAK_LATENT_COLUMNS + 768 + 160, the
    last with SOAK_LAST_VALID latent and SOAK_TEXT_VALID text columns
    valid, the shape and mask phase 4 holds and times.  Returns the launch counts."""
    import collections
    import tempfile

    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.examples import soak_long_stream as soak
    from echo_tts_torch.models import dit as tdit

    n_blocks = 16
    steps, n_layers = SAMPLER_DEFAULTS["num_steps"], models.dit_cfg.num_layers
    shapes, last = collections.Counter(), {}
    run_attention = tdit.fused_joint_attention

    def recording_attention(q, *a, **k):
        shapes[(q.shape[0], q.shape[1], a[2].shape[1])] += 1
        last["mask"] = a[4]
        return run_attention(q, *a, **k)

    name = "r: examples.soak_long_stream, 16 x 320 latents"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "soak.json")
        tdit.fused_joint_attention = recording_attention
        try:
            _reset(counters)
            rc = soak.main(["--blocks", str(n_blocks), "--report", path],
                           models=models)
            got = _read(counters)
        finally:
            tdit.fused_joint_attention = run_attention
        with open(path) as f:
            report = json.load(f)
    per_block = n_layers * steps
    n_calls = n_blocks + soak.WARM_BLOCKS
    want = _want(attn=per_block * n_calls, res_stream=3 * n_calls)
    want_measured = {"joint_attention": per_block * n_blocks, "res_stack": 0,
                     "res_stack_stream": 3 * n_blocks}
    t_last = SOAK_LATENT_COLUMNS + 768 + 160
    valid = int(last["mask"][0, :SOAK_LATENT_COLUMNS].sum())
    text_valid = int(last["mask"][0, SOAK_LATENT_COLUMNS:
                                  SOAK_LATENT_COLUMNS + 768].sum())
    if (rc != 0 or not report["ok"] or got != want
            or report["launches"] != want_measured
            or report["total_latents"] != 5120 or report["audio_samples"]
            != 5120 * models.dac_cfg.frame_length
            or "memory_growth_mb" not in report
            or "tail_over_mid_ratio" not in report
            or max(t for _, _, t in shapes) != t_last
            or not {(3, 320, t_last), (1, 320, t_last)} <= set(shapes)
            or valid != SOAK_LAST_VALID or text_valid != SOAK_TEXT_VALID):
        raise AssertionError(
            f"{name}: exit {rc}, failures {report['failures']}; launches "
            f"{got}, want {want}; measured {report['launches']}, want "
            f"{want_measured}; kernel A (GB, S, T) {dict(shapes)}; the last "
            f"block's valid latent columns {valid}, text columns "
            f"{text_valid}")
    blocks = report["blocks"]
    log(f"  request {name}: tail/mid {report['tail_over_mid_ratio']:.4f} "
        f"(bound {soak.TAIL_OVER_MID_BOUND}), memory_allocated growth "
        f"{report['memory_growth_mb']:.3f} MB (bound "
        f"{soak.MEMORY_GROWTH_BOUND / 2**20:.0f} MB), "
        f"{report['audio_samples']} finite samples ({report['audio_seconds']:.2f}"
        f" s audio) in {report['wall_seconds']:.2f} s: streamed RTF "
        f"{report['streamed_rtf']:.3f}x; warm pass ({report['warm_blocks']} "
        f"blocks) {report['warm_pass_seconds']:.2f} s; block ms "
        f"{[round(b['block_ms'], 1) for b in blocks]}; launches measured "
        f"{report['launches']}, whole call {got}; kernel A (GB, S, T) "
        f"{dict(shapes)}, the last block's valid latent columns {valid} of "
        f"{SOAK_LATENT_COLUMNS}, text columns {text_valid} of 768 ({card})")
    return got


def request_fullsize(models, counters, n_layers: int,
                     n_int8_linears: int) -> dict:
    """Request (s): tools/check_fullsize.check on phase 3's DiT (24/14/14
    layers, seeded random bf16 weights): one CFG forward (GB = 3) in bf16
    with kernel A within rel-RMS 0.05 and max-abs 0.30 of the same weights
    in fp32 (plain attention, TF32 off), the W8A8 forward beside it.
    Launches: kernel A 24 (bf16) + 24 (W8A8), kernel C 8 x 24, none in
    fp32.  Returns the launch counts."""
    from echo_tts_torch.tools import check_fullsize

    _reset(counters)
    report = check_fullsize.check(models.dit)
    got = _read(counters)
    want = _want(attn=2 * n_layers, int8=n_int8_linears * n_layers)
    name = "s: tools.check_fullsize, full-depth bf16 forward vs fp32"
    if report["failures"] or got != want:
        raise AssertionError(f"{name}: {report['failures']}; launches {got}, "
                             f"want {want}")
    log(f"  request {name}: rel-RMS {report['rel_rms_err']:.4e} (bound "
        f"{check_fullsize.ENVELOPE_REL_RMS}), max-abs "
        f"{report['max_abs_err']:.4e} (bound "
        f"{check_fullsize.ENVELOPE_MAX_ABS}), fp32 output std "
        f"{report['out_std']:.4f}; W8A8 from bf16 rel-RMS "
        f"{report['int8_rel_rms_vs_bf16']:.4e}, from fp32 "
        f"{report['int8_rel_rms_vs_fp32']:.4e} (information); launches {got}; "
        f"{report['wall_s']:.1f} s")
    return got


# ---------------------------------------------------------------------------
# phase 3, continued: training, data, distillation, the bundle, the demo
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-4           # make_optimizer's default
# Request (i)'s gradients with kernel A are held against the fp32 step
# (plain attention) at the timestep the bf16 step sees, t rounded to bf16
# (echo_tts_torch/tools/train_checks.py says why): no farther from it
# than GRAD_FP32_RATIO times the plain bf16 step is.  Kernel A's step and
# the plain one differ by their own bf16 roundings, which the 24 layers
# carry into the gradients, so the two bf16 steps sit about as far from
# each other as each from the fp32 one (1.5-1.7e-2 apart, 1.9-2.1e-2 from
# it, so 1e-2 between them would sit below bf16's own noise); each kernel
# call is held to 1e-2 in phase 4.  The ratio read 0.9952-1.0014 over
# seeds 0-3 at 24 layers and seed 0 at 1, 4 and 12 (train_checks.py on an
# H100 80GB HBM3 at 700 W); 1.02 lets through a kernel error of at most a
# fifth of the bf16 step's own, added independently.
GRAD_FP32_RATIO = 1.02


class StepTimes:
    """Wraps a module's step-function factory (make_train_step,
    make_distill_step) so that each step it makes is timed on the host
    clock between synchronises; `ms` collects the steps' times."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.make = getattr(module, name)
        self.ms = []

    def __enter__(self):
        import torch

        def make(*a, **k):
            step = self.make(*a, **k)

            def timed_step(*sa, **sk):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*sa, **sk)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return timed_step

        setattr(self.module, self.name, make)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.make)
        return False


def _free():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def request_train(counters, card: str) -> dict:
    """Request (i): `train` on the published 24-layer DiT (blockwise=False,
    as the JAX package trains it; seeded random bf16 weights) at B = 2 on
    one batch of the DataConfig shapes, t and eps fixed across steps:
    three steps in each remat mode, each from the same initial weights.
    Per mode: one step's gradients (flow_matching_loss backward, as the
    first update sees them) against "none"'s (rel-RMS 1e-2), kernel A's
    launches per step (exact: L under "none", "attn", "dots_all"; 2 L
    under "full" and "dots", whose recompute re-runs the forward), the
    step ms (median of three, host clock between synchronises), the peak
    memory (torch.cuda.max_memory_allocated, reset before the run, and
    what was resident then); the loss finite and lower at step 3 than at
    step 1, and the first-step losses of all modes within relative 1e-3.
    Then the same step with joint_attention_plain in place of the kernel,
    in bf16 and in fp32 at the bf16 step's timestep: kernel A's step no
    farther from the fp32 one than GRAD_FP32_RATIO times the plain bf16
    step; and one train step at blockwise=True, whose
    latent encoder the loss does not reach: its gradients stay allocated
    at zero and AdamW holds state for them (the decay optax applies)."""
    import itertools

    import torch
    from echo_tts_torch.config import base_dit_config
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.tools.train_checks import (grad_rel_rms,
                                                   precision_gaps,
                                                   step_grads, train_draws)
    from echo_tts_torch.train import loop as tloop

    t0 = time.perf_counter()
    model0 = tdit.init_dit(base_dit_config(blockwise=False), seed=0)
    cfg = model0.cfg
    n_layers = cfg.num_layers
    batch, t, eps = train_draws(cfg, seed=0)
    log(f"  request i: DiT {sum(p.numel() for p in model0.parameters()) / 1e9:.3f}"
        f" B params (blockwise=False), init {time.perf_counter() - t0:.1f} s")
    per_step = {"none": n_layers, "full": 2 * n_layers, "dots": 2 * n_layers,
                "dots_all": n_layers, "attn": n_layers}

    total = dict.fromkeys(counters, 0)
    modes, ref = {}, None
    for mode in tdit.REMAT_MODES:
        _reset(counters)
        loss0, grads = step_grads(model0, batch, t, eps, remat=mode)
        torch.cuda.synchronize()
        got = _read(counters)
        if got != _want(attn=per_step[mode]):
            raise AssertionError(f"i {mode}: one step's launches {got}, want "
                                 f"{_want(attn=per_step[mode])}")
        if ref is None:
            ref, rel = grads, 0.0
        else:
            rel = grad_rel_rms(grads, ref)
            del grads
            if rel > REL_RMS_BOUND:
                raise AssertionError(f"i {mode}: gradients rel-RMS {rel:.3e} "
                                     f"from none's > {REL_RMS_BOUND}")
        _free()
        losses = []
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        with StepTimes(tloop, "make_train_step") as times:
            state = tloop.train(model0, itertools.repeat(batch), num_steps=3,
                                lr=TRAIN_LR, fixed_noise=(t, eps), remat=mode,
                                on_step=lambda i, v: losses.append(v))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        got = _read(counters)
        for k, v in got.items():
            total[k] += v
        if got != _want(attn=3 * per_step[mode]):
            raise AssertionError(f"i {mode}: launches {got} over three steps, "
                                 f"want {_want(attn=3 * per_step[mode])}")
        if not (np.isfinite(losses).all() and losses[2] < losses[0]):
            raise AssertionError(f"i {mode}: losses {losses}")
        if abs(losses[0] - loss0) > 1e-3 * abs(loss0):
            raise AssertionError(f"i {mode}: first step loss {losses[0]} "
                                 f"against its gradient step's {loss0}")
        modes[mode] = dict(step_ms=float(np.median(times.ms)),
                           steps_ms=times.ms, losses=losses,
                           peak_gib=peak / 2**30,
                           resident_gib=resident / 2**30,
                           launches_per_step=got["joint_attention"] // 3,
                           grad_rel_rms_vs_none=rel)
        log(f"  request i, remat {mode}: step ms {times.ms[0]:.1f} / "
            f"{times.ms[1]:.1f} / {times.ms[2]:.1f} (median "
            f"{modes[mode]['step_ms']:.1f}); losses "
            f"{[round(v, 5) for v in losses]}; peak {peak / 2**30:.2f} GiB "
            f"({resident / 2**30:.2f} GiB resident before); kernel A "
            f"launches per step {got['joint_attention'] // 3}; gradients "
            f"rel-RMS {rel:.3e} from none's ({card})")
        del state
        _free()
    first = [m["losses"][0] for m in modes.values()]
    if max(first) - min(first) > 1e-3 * abs(first[0]):
        raise AssertionError(f"i: first-step losses {first} differ by more "
                             "than relative 1e-3")

    # the same step with the plain version in place of kernel A, in bf16
    # and in fp32 (the model cast; the kernel takes bf16 only)
    _reset(counters)
    gaps = precision_gaps(model0, batch, t, eps, kernel_grads=ref,
                          exact_t=False)
    torch.cuda.synchronize()
    if _read(counters) != _want():
        raise AssertionError("i: the plain steps launched a kernel")
    log(f"  request i: one step's gradients, rel-RMS: kernel A against "
        f"joint_attention_plain, both bf16, {gaps['kernel_vs_plain']:.3e}; "
        f"against the fp32 step at the bf16 step's t: kernel A "
        f"{gaps['kernel_vs_fp32']:.3e}, plain bf16 {gaps['plain_vs_fp32']:.3e}"
        f", ratio {gaps['ratio']:.4f} (bound {GRAD_FP32_RATIO}) ({card})")
    if gaps["ratio"] > GRAD_FP32_RATIO:
        raise AssertionError(f"i: kernel A's step gradients rel-RMS "
                             f"{gaps['kernel_vs_fp32']:.3e} from the fp32 "
                             f"step's, the plain bf16 step's "
                             f"{gaps['plain_vs_fp32']:.3e}")
    del ref, model0
    _free()

    # blockwise=True: the latent encoder is trained but never reached
    model_bw = tdit.init_dit(base_dit_config(blockwise=True), seed=0)
    _reset(counters)
    state = tloop.train(model_bw, itertools.repeat(batch), num_steps=1,
                        lr=TRAIN_LR, fixed_noise=(t, eps))
    torch.cuda.synchronize()
    got = _read(counters)
    for k, v in got.items():
        total[k] += v
    if got != _want(attn=n_layers):
        raise AssertionError(f"i blockwise: launches {got}")
    unreached = list(state.model.latent_encoder.parameters())
    if not all(p.grad is not None and not bool(p.grad.any())
               and "exp_avg" in state.optimizer.state[p] for p in unreached):
        raise AssertionError("i blockwise: the latent encoder's gradients "
                             "are not zero, or AdamW holds no state for them")
    log(f"  request i, blockwise=True: one step, {len(unreached)} latent-"
        f"encoder tensors ({sum(p.numel() for p in unreached) / 1e6:.1f} M "
        f"params) with zero gradients under AdamW's decay; launches {got}")
    del state, model_bw
    _free()
    return dict(modes=modes, grad_rel_rms=gaps, launches=total)


def request_data(models, counters) -> tuple:
    """Request (j): write_shards on tests/data/voice.wav (one utterance:
    one encode, kernel B 3 calls), load_shard, then iter_batches (batch 1)
    feeds one train step (kernel A 24 under "attn").  Returns (launch
    counts, the step's loss)."""
    import tempfile

    import torch
    from echo_tts_torch.pipeline import audio_io
    from echo_tts_torch.train import data as tdata
    from echo_tts_torch.train import loop as tloop

    voice = audio_io.load_audio(VOICE)
    n_lat = voice.shape[1] // models.dac_cfg.frame_length
    total = dict.fromkeys(counters, 0)
    with tempfile.TemporaryDirectory() as work:
        _reset(counters)
        t0 = time.perf_counter()
        shards = tdata.write_shards(models, [(voice, TEXT)], work)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        got = _read(counters)
        if got != _want(res=3):
            raise AssertionError(f"j: write_shards launches {got}")
        total = dict(got)
        utts = tdata.load_shard(shards[0])
        if len(utts) != 1 or utts[0][0].shape != (n_lat, 80):
            raise AssertionError(f"j: shard {[u[0].shape for u in utts]}")
        batch = next(tdata.iter_batches(shards, models, batch_size=1))
    ps = models.dit_cfg.speaker_patch_size
    k = min(n_lat // 2, 640) // ps * ps        # the speaker clip, then the target
    if (batch["latents"].shape != (1, 640, 80)
            or int(batch["latent_mask"].sum()) != min(n_lat - k, 640)
            or int(batch["speaker_mask"].sum()) != k):
        raise AssertionError(f"j: batch {[(n, v.shape) for n, v in batch.items()]}")
    _reset(counters)
    losses = []
    state = tloop.train(models.dit, [batch], num_steps=1,
                        on_step=lambda i, v: losses.append(v))
    torch.cuda.synchronize()
    got = _read(counters)
    for kk, v in got.items():
        total[kk] += v
    if got != _want(attn=models.dit_cfg.num_layers) or not np.isfinite(losses).all():
        raise AssertionError(f"j: train step launches {got}, loss {losses}")
    log(f"  request j: write_shards on voice.wav: {n_lat} latents, encode "
        f"{enc_s * 1e3:.1f} ms, kernel B 3 calls; iter_batches -> one train "
        f"step, loss {losses[0]:.5f}, kernel A {got['joint_attention']}")
    del state
    _free()
    return total, losses[0]


def request_distill(models, batch, counters, card: str) -> tuple:
    """Request (k): two `distill` steps from the published 24-layer teacher
    (models.dit, seeded random bf16 weights) into a student of the same
    size, num_student_steps=8, substeps=5, plain and then quant-aware.
    Per step kernel A launches 5 x 24 times for the teacher (no grad, 3B
    rows) and 24 for the student (under grad); no kernel C (QAT runs
    through qat_dot).  Prints the losses, the step ms, the peak memory.
    Returns (launch counts, the quant-aware student, results)."""
    import itertools

    import torch
    from echo_tts_torch.train import distill as tdistill

    n_layers = models.dit_cfg.num_layers
    per_step = (5 + 1) * n_layers
    total = dict.fromkeys(counters, 0)
    results = {}
    for quant_aware in (False, True):
        student = None                      # the plain one goes first
        name = "quant-aware" if quant_aware else "plain"
        losses = []
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        with StepTimes(tdistill, "make_distill_step") as times:
            state = tdistill.distill(
                models.dit, itertools.repeat(batch), num_steps=2,
                num_student_steps=8, substeps=5, quant_aware=quant_aware,
                on_step=lambda i, v: losses.append(v))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        got = _read(counters)
        for k, v in got.items():
            total[k] += v
        if got != _want(attn=2 * per_step) or not np.isfinite(losses).all():
            raise AssertionError(f"k {name}: launches {got}, want "
                                 f"{_want(attn=2 * per_step)}; losses {losses}")
        results[name] = dict(losses=losses, steps_ms=times.ms,
                             peak_gib=peak / 2**30,
                             resident_gib=resident / 2**30,
                             launches_per_step=per_step)
        log(f"  request k, {name}: losses {[round(v, 5) for v in losses]}; "
            f"step ms {[round(v, 1) for v in times.ms]}; peak "
            f"{peak / 2**30:.2f} GiB ({resident / 2**30:.2f} resident before);"
            f" kernel A per step {per_step} (teacher 5 x {n_layers} at GB = 6"
            f" without grad, student {n_layers} under grad) ({card})")
        student = state.model
        del state
        student.zero_grad(set_to_none=True)
        student.requires_grad_(False)
        _free()
    return total, student, results


def request_bundle(models, student, counters) -> tuple:
    """Request (l): save_checkpoint of the quant-aware student's whole
    bundle (student DiT, the codec, PCA), then
    serve.models.load_models(model_dir=bundle): its parameters bit for bit
    the saved ones; then one handler job with few_step_sampler_params(8)
    through serve_checkpoint_smoke, in bf16 and under ECHO_DIT_QUANT=int8
    (kernel C): audio finite and not silent, 8 x 24 kernel A launches (and
    8 x 8 x 24 kernel C in the int8 job), one decode (kernel B 3 calls).
    Prints the save and load seconds and the bundle's bytes."""
    import dataclasses
    import tempfile

    import torch
    from echo_tts_torch.serve import models as serve_models
    from echo_tts_torch.tools.checkpoint import save_checkpoint
    from echo_tts_torch.train.recipe import serve_checkpoint_smoke

    bundle = dataclasses.replace(models, dit=student)
    total = dict.fromkeys(counters, 0)
    out = {}
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "bundle")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, bundle)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        serve_models.clear_models()
        t0 = time.perf_counter()
        loaded = serve_models.load_models(model_dir=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        for mod_a, mod_b in ((loaded.dit, student), (loaded.dac, models.dac)):
            sa, sb = mod_a.state_dict(), mod_b.state_dict()
            if list(sa) != list(sb) or not all(
                    sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k])
                    for k in sa):
                raise AssertionError("l: the bundle's parameters did not "
                                     "round-trip bit for bit")
        if not (torch.equal(loaded.pca["components"], models.pca["components"])
                and loaded.pca["latent_scale"] == models.pca["latent_scale"]):
            raise AssertionError("l: the PCA state did not round-trip")
        del loaded
        serve_models.clear_models()
        _free()
        log(f"  request l: save_checkpoint {save_s:.2f} s, "
            f"{nbytes / 2**30:.3f} GiB in {sorted(os.listdir(path))}; "
            f"serve.models.load_models {load_s:.2f} s; parameters bit-equal")
        out.update(save_s=save_s, load_s=load_s, bytes=nbytes)
        n_layers = models.dit_cfg.num_layers
        for int8 in (False, True):
            _reset(counters)
            t0 = time.perf_counter()
            smoke = serve_checkpoint_smoke(path, num_student_steps=8,
                                           sequence_length=640, int8=int8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _read(counters)
            for k, v in got.items():
                total[k] += v
            want = _want(attn=8 * n_layers, res=3,
                         int8=8 * 8 * n_layers if int8 else 0)
            name = "int8" if int8 else "bf16"
            if (not smoke["ok"] or smoke["audio_peak"] <= 1e-4
                    or smoke["quant_reported"] != ("int8" if int8 else "none")
                    or got != want):
                raise AssertionError(f"l {name}: {smoke}; launches {got}, "
                                     f"want {want}")
            out[name] = dict(smoke, wall_s=wall)
            log(f"  request l, handler job {name}: {wall:.2f} s (load "
                f"included), {smoke['duration_seconds']} s audio, peak "
                f"{smoke['audio_peak']:.3f}; launches {got}")
    serve_models.clear_models()
    return total, out


def request_demo(models, counters) -> dict:
    """Request (m): one DemoSession.generate_audio with voice.wav and no
    gradio (the defaults: 40 steps, the text and speaker buckets), seed
    11: kernel A 960, kernel B 3 per encoded speaker chunk and 3 for the
    decode; its audio bit for bit sample_pipeline's with the same
    arguments and seed."""
    import functools
    import tempfile

    import torch
    from echo_tts_torch.demo import app
    from echo_tts_torch.pipeline import audio_io, pipeline as pl

    recorded = []
    run = app.sample_pipeline

    def recording(*a, **k):
        audio, text = run(*a, **k)
        recorded.append(audio)
        return audio, text

    with tempfile.TemporaryDirectory() as work:
        session = app.DemoSession(models, temp_dir=work)
        app.sample_pipeline = recording
        try:
            _reset(counters)
            t0 = time.perf_counter()
            result = session.generate_audio(TEXT, VOICE, rng_seed=11)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            app.sample_pipeline = run
        got = _read(counters)
        written, _ = audio_io.read_wav(result.audio_path)
    voice = audio_io.load_audio(VOICE)
    spl = models.dac_cfg.frame_length
    # the session's speaker bucket, as generate_audio picks it
    pad_spk = app.find_min_bucket_gte(
        app.DEFAULT_SPEAKER_BUCKETS,
        voice.shape[1] // spl // models.dit_cfg.speaker_patch_size
        * models.dit_cfg.speaker_patch_size)
    n_chunks = math.ceil(min(voice.shape[1], pad_spk * spl) / (640 * spl))
    if got != _want(attn=40 * models.dit_cfg.num_layers,
                    res=3 * n_chunks + 3):
        raise AssertionError(f"m: launches {got}")
    fn = functools.partial(
        pl.euler_sample_fn, num_steps=40, cfg_scale_text=3.0,
        cfg_scale_speaker=8.0, cfg_min_t=0.5, cfg_max_t=1.0,
        truncation_factor=1.0, rescale_k=None, rescale_sigma=3.0,
        speaker_kv_scale=None, speaker_kv_min_t=None,
        speaker_kv_max_layers=None, sequence_length=640)
    want, _ = pl.sample_pipeline(models, fn, TEXT, voice, 11,
                                 pad_to_max_text_length=768,
                                 pad_to_max_speaker_latent_length=pad_spk)
    if len(recorded) != 1 or not np.array_equal(recorded[0], want):
        raise AssertionError("m: the session's audio is not sample_pipeline's "
                             "bit for bit")
    if written.shape[1] != want.shape[1] or not np.isfinite(want).all():
        raise AssertionError(f"m: WAV {written.shape}, audio {want.shape}")
    log(f"  request m: DemoSession.generate_audio {wall * 1e3:.1f} ms, "
        f"{want.shape[1] / 44100:.2f} s audio; launches {got}; audio equals "
        "sample_pipeline's bit for bit")
    return got


def phase_training(card: str) -> tuple:
    """Requests (i)-(m) at the published width and depth; returns (their
    launch counts, their results)."""
    import torch
    from echo_tts_torch.pipeline import pipeline as pl
    from echo_tts_torch.serve import models as serve_models
    from echo_tts_torch.tools.train_checks import train_batch

    log("phase 3, training: train, data, distill, bundle, demo (full width "
        "and depth, seeded random weights)")
    serve_models.clear_models()
    _free()
    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)

    def add(got):
        for k, v in got.items():
            launches[k] += v

    train = request_train(counters, card)
    add(train["launches"])
    models = pl.random_models()
    got, data_loss = request_data(models, counters)
    add(got)
    got, student, distill = request_distill(
        models, train_batch(models.dit_cfg, seed=62), counters, card)
    add(got)
    got, bundle = request_bundle(models, student, counters)
    add(got)
    del student
    _free()
    add(request_demo(models, counters))
    log(f"  training requests' peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB since the "
        f"last reset")
    return launches, dict(train=train["modes"],
                          grad_rel_rms=train["grad_rel_rms"],
                          data_loss=data_loss, distill=distill, bundle=bundle)


# ---------------------------------------------------------------------------
# phase 3, scale-out: requests (n) and (o)
# ---------------------------------------------------------------------------

# Request (o)'s TP=2 runs are held to the fp32 run (plain attention, TF32
# off) on the same inputs: the sharded bf16 forward and 40-step latents no
# farther from it than TP_FP32_RATIO times the unsharded bf16 ones are,
# the sharded W8A8 forward no farther than W8A8_FP32_RATIO times the
# unsharded W8A8 forward.  The sharded run differs from the unsharded one
# only in roundings: column halves of a bf16 product are bit for bit the
# whole product's, and the row-parallel partial sums stay fp32 until
# their all-reduce (99.7-99.9 % of a product's outputs then round to the
# unsharded bits, against 62.5 % with bf16 partials; H100 80GB HBM3,
# 700 W).  The rest, one ulp here and there, the 24 random-weight layers
# carry to 1.07e-2 rel-RMS between the two bf16 forwards, each 1.39e-2
# from fp32: a bound of 1e-2 between them would sit below bf16's own
# noise, as request (i) found for its gradients.  In W8A8 every such
# difference can move an activation across an int8 rounding boundary,
# and the sharded and unsharded forwards sit 2.76e-2 apart, as far as the
# W8A8 forward sits from the bf16 one.  The row-parallel W8A8 product
# itself is held bit for bit (rowpar_w8a8_exact), and kernel C's
# given-scale instance against its plain version in phase 4.
# (The ratios are parallel_checks.TP_FP32_RATIO and W8A8_FP32_RATIO.)
TRAIN_DEPTH = 4           # request (o)'s train steps: DiT layers (encoders 2)


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def request_world1(req_b: dict, counters, card: str) -> tuple:
    """Request (n): request (b) again through the scale-out layer at world
    size 1: initialize_from_env (NCCL, ECHO_COORD on localhost),
    global_mesh(tp=1), shard_models and place_request, then the sampler
    with the mesh: its latents bit for bit (b)'s, 960 kernel A launches.
    Then, on the same inputs, the fp32 sampler (plain attention) that
    request (o) holds its TP=2 latents to, and the fp32 CFG forward its
    TP=2 forward is measured against.  Returns (launches, the fp32
    latents, the fp32 forward)."""
    import torch
    import torch.distributed as dist
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.parallel import distributed as pdist
    from echo_tts_torch.parallel import inference as pinf
    from echo_tts_torch.pipeline import pipeline as pl
    from echo_tts_torch.sampler.euler import (
        sample_euler_cfg_independent_guidances as sample)
    from echo_tts_torch.tools import parallel_checks as pc

    models = pl.random_models()          # seed 0: request (b)'s weights
    dev = models.device
    gen = torch.Generator(device=dev).manual_seed(int(req_b["seed"]))
    noise = torch.randn((1, SAMPLER_DEFAULTS["sequence_length"],
                         models.dit_cfg.latent_size), generator=gen,
                        device=dev, dtype=torch.float32)
    req_b["noise"] = noise
    env = {"ECHO_COORD": f"127.0.0.1:{_free_port()}", "ECHO_NUM_PROCS": "1",
           "ECHO_PROC_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not pdist.initialize_from_env() or dist.get_backend() != "nccl":
            raise AssertionError("n: initialize_from_env did not join NCCL")
        mesh = pdist.global_mesh(tp=1)
        models = pinf.shard_models(models, mesh)
        placed = pinf.place_request(mesh, req_b["spk"], req_b["smask"],
                                    req_b["ids"], req_b["tmask"], noise)
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = sample(models.dit, *placed[:4], initial_noise=placed[4],
                     dtype=models.dtype, mesh=mesh, **SAMPLER_DEFAULTS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = _read(counters)
        world = dist.get_world_size()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    n_attn = models.dit_cfg.num_layers * SAMPLER_DEFAULTS["num_steps"]
    if got != _want(attn=n_attn):
        raise AssertionError(f"n: launches {got}, want {_want(attn=n_attn)}")
    if not torch.equal(lat, req_b["latents"]):
        raise AssertionError("n: the world-size-1 latents differ from request "
                             "(b)'s")
    log(f"  request n: NCCL world of {world}, global_mesh(tp=1), request "
        f"(b) through shard_models/place_request: latents bit-equal to (b)'s;"
        f" launches {got}; sampler {wall:.1f} ms ({card})")

    # the fp32 run on (b)'s inputs (plain attention: kernel A takes bf16)
    _reset(counters)
    lat32, fwd32 = pc.fp32_refs(models.dit, req_b)
    torch.cuda.synchronize()
    if _read(counters) != _want():
        raise AssertionError("n: the fp32 run launched a kernel")
    del models
    _free()
    return got, lat32, fwd32


def _scale_out_rank(rank: int, port: int, out_dir: str, payload: dict):
    """One of request (o)'s two ranks: a gloo world on the one card."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    from echo_tts_torch.config import base_dit_config
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.parallel import mesh as pmesh
    from echo_tts_torch.tools import parallel_checks as pc
    from echo_tts_torch.tools.train_checks import train_batch

    dev = torch.device("cuda")
    tp2 = pmesh.make_mesh(dp=1, tp=2)
    dp2 = pmesh.make_mesh(dp=2, tp=1)
    res = {}

    def done(key):
        print(f"  request o rank {rank} {key}: {json.dumps(res[key])}",
              flush=True)

    model = tdit.init_dit(base_dit_config(), device=dev, seed=0)
    res["sp"] = pc.sp_check(model, tp2)
    done("sp")
    req2 = pc.request_inputs(dev, batch=2)
    ref2, res["dp_unsharded_ms"] = pc.wall_ms(lambda: pc.sample(model, req2))
    res["dp"] = pc.dp_sample_check(model, dp2, req2, ref2)
    done("dp")
    del ref2
    req_b = {k: v.to(dev) for k, v in payload["req_b"].items()}
    res["tp_forward"] = pc.tp_forward_check(
        model, tp2, req_b, payload["fp32_forward"].to(dev))
    done("tp_forward")
    pc.reset_launches()
    lat, ms = pc.wall_ms(lambda: pc.sample(model, req_b, tp2))
    lat_b, lat32 = req_b["latents"], payload["fp32_latents"].to(dev)
    res["tp_sample"] = dict(
        ms=ms, launches=pc.launches(), rel_rms_vs_unsharded=pc.rel_rms(lat, lat_b),
        rel_rms_vs_fp32=pc.rel_rms(lat, lat32),
        unsharded_vs_fp32=pc.rel_rms(lat_b, lat32))
    done("tp_sample")
    del model
    torch.cuda.empty_cache()
    cfg = pc.cut_config(TRAIN_DEPTH)
    g = torch.Generator(device=dev).manual_seed(61)
    batch = train_batch(cfg, 60, dev)
    t = torch.rand((2,), generator=g, device=dev)
    eps = torch.randn((2, 640, cfg.latent_size), generator=g, device=dev)
    res["train_tp"] = pc.train_check(cfg, tp2, batch, t, eps, dev)
    done("train_tp")
    res["train_dp"] = pc.train_check(cfg, dp2, batch, t, eps, dev)
    done("train_dp")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def request_two_ranks(req_b: dict, lat32, fwd32, card: str) -> tuple:
    """Request (o): two ranks on the one card (torch.multiprocessing spawn,
    a gloo world: NCCL refuses two ranks on one device), each building the
    published DiT from seed 0 and its unsharded references on the card:
    SP tp=2 (the 6400-latent speaker prefill within 1e-2 of
    get_kv_cache_speaker), DP=2 (a B = 2 request's row within 1e-2 of the
    unsharded pass, its noise row bit for bit, 960 kernel A launches),
    TP=2 (one CFG forward within 1e-2 of the unsharded one, 24 kernel A
    launches at 8 heads; the W8A8 forward within 1e-2 of the unsharded
    W8A8 one, its row-parallel products through kernel C's given-scale
    instance: 144 fused and 48 given-scale launches; each no farther from
    the fp32 forward than TP_FP32_RATIO, W8A8_FP32_RATIO times the
    unsharded one, and layer 0's row-parallel W8A8 product bit for bit
    the whole one; request (b)'s 40 steps, 960 launches, no farther from
    the fp32 latents than TP_FP32_RATIO times (b)'s own; the distances
    between sharded and unsharded runs are printed beside them), and one
    TP=2 and one DP=2 train step
    at TRAIN_DEPTH layers against the one-card step (loss within 1e-3,
    gradients within 1e-2).  A rank that fails fails the run.  Returns
    (the launches summed over the ranks, the results)."""
    import tempfile

    import torch
    from echo_tts_torch.tools import parallel_checks as pc

    payload = {"req_b": {k: req_b[k].cpu() for k in
                         ("spk", "smask", "ids", "tmask", "noise", "latents")},
               "fp32_latents": lat32.cpu(), "fp32_forward": fwd32.cpu()}
    _free()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(_scale_out_rank,
                                    args=(_free_port(), out_dir, payload),
                                    nprocs=2)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    n_steps, n_layers = 40, 24
    total = dict.fromkeys(kernel_counters(), 0)
    for r, res in enumerate(ranks):
        failed = pc.failures(res)
        if failed:
            raise AssertionError(f"o rank {r}: (distance, bound) {failed}")
        want = {
            "dp": dict(joint_attention=n_layers * n_steps, int8_matmul=0,
                       int8_matmul_partial=0),
            "tp_forward": dict(joint_attention=n_layers, int8_matmul=0,
                               int8_matmul_partial=0),
            "tp_forward_w8a8": dict(joint_attention=n_layers,
                                    int8_matmul=6 * n_layers,
                                    int8_matmul_partial=2 * n_layers),
            "tp_sample": dict(joint_attention=n_layers * n_steps,
                              int8_matmul=0, int8_matmul_partial=0),
            "train_tp": dict(joint_attention=TRAIN_DEPTH, int8_matmul=0,
                             int8_matmul_partial=0),
            "train_dp": dict(joint_attention=TRAIN_DEPTH, int8_matmul=0,
                             int8_matmul_partial=0)}
        got = {"dp": res["dp"]["launches"],
               "tp_forward": res["tp_forward"]["launches"],
               "tp_forward_w8a8": res["tp_forward"]["w8a8_launches"],
               "tp_sample": res["tp_sample"]["launches"],
               "train_tp": res["train_tp"]["launches"],
               "train_dp": res["train_dp"]["launches"]}
        if (got != want or res["tp_forward"]["local_heads"] != 8
                or res["dp"]["rows"] != [r, r + 1]):
            raise AssertionError(
                f"o rank {r}: launches {got}, want {want}; heads "
                f"{res['tp_forward']['local_heads']}; rows {res['dp']['rows']}")
        for counts in got.values():
            for k, v in counts.items():
                total[k] += v
        log(f"  request o rank {r}: SP tp=2 6400 latents K/V rel-RMS "
            f"{res['sp']['k_rel_rms']:.3e}/{res['sp']['v_rel_rms']:.3e} "
            f"({res['sp']['ms']:.1f} ms, unsharded {res['sp']['unsharded_ms']:.1f});"
            f" DP=2 row rel-RMS {res['dp']['rel_rms']:.3e}, noise bit-equal, "
            f"{res['dp']['ms']:.1f} ms (B = 2 unsharded "
            f"{res['dp_unsharded_ms']:.1f}); TP=2 forward rel-RMS "
            f"{res['tp_forward']['rel_rms']:.3e} ({res['tp_forward']['ms']:.1f}"
            f" ms; from fp32 {res['tp_forward']['rel_rms_vs_fp32']:.3e}, the "
            f"unsharded bf16's {res['tp_forward']['unsharded_vs_fp32']:.3e},"
            f" bound x{pc.TP_FP32_RATIO}), W8A8 "
            f"{res['tp_forward']['w8a8_rel_rms']:.3e} (from fp32 "
            f"{res['tp_forward']['w8a8_vs_fp32']:.3e}, the unsharded W8A8's "
            f"{res['tp_forward']['w8a8_unsharded_vs_fp32']:.3e}, bound "
            f"x{pc.W8A8_FP32_RATIO}; the unsharded W8A8 from bf16 "
            f"{res['tp_forward']['w8a8_vs_bf16']:.3e}; row-parallel product "
            f"bit-equal) "
            f"({res['tp_forward']['w8a8_ms']:.1f} ms); TP=2 request (b) 40 "
            f"steps {res['tp_sample']['ms']:.1f} ms: rel-RMS from the "
            f"unsharded latents {res['tp_sample']['rel_rms_vs_unsharded']:.3e}"
            f", from fp32 {res['tp_sample']['rel_rms_vs_fp32']:.3e} (the "
            f"unsharded bf16's {res['tp_sample']['unsharded_vs_fp32']:.3e}, "
            f"bound x{pc.TP_FP32_RATIO}); train step at {TRAIN_DEPTH} layers: "
            f"TP=2 loss {res['train_tp']['loss']:.6f} (one card "
            f"{res['train_tp']['loss_ref']:.6f}) gradients rel-RMS "
            f"{res['train_tp']['grad_rel_rms']:.3e} ({res['train_tp']['ms']:.1f}"
            f" ms), DP=2 loss {res['train_dp']['loss']:.6f} gradients "
            f"{res['train_dp']['grad_rel_rms']:.3e} "
            f"({res['train_dp']['ms']:.1f} ms) ({card})")
    log(f"  request o: two ranks on one card over gloo, {wall:.1f} s")
    return total, ranks


def phase_scale_out(card: str, req_b: dict) -> tuple:
    """Requests (n) and (o); returns (their launch counts, (o)'s results)."""
    log("phase 3, scale-out: world size 1 over NCCL; two ranks on one card "
        "over gloo (full width, seeded random weights)")
    counters = kernel_counters()
    got, lat32, fwd32 = request_world1(req_b, counters, card)
    launches = dict(got)
    got, ranks = request_two_ranks(req_b, lat32, fwd32, card)
    for k, v in got.items():
        launches[k] += v
    return launches, ranks


def summary(case: dict, *extra) -> dict:
    """A case's shape, times, bound and errors, for the kernels line."""
    keys = ("shape", "ms", "timer", "host_us", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bound_share", "max_abs_err",
            "rel_rms") + extra
    return {k: case[k] for k in keys if k in case}


def kernel_entry(name, source, replaces, cases, main, launches, **extra):
    """One entry of the {"kernels": [...]} line: the main case's numbers,
    and the worst error over all cases."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in cases),
                rel_rms=max(r["rel_rms"] for r in cases),
                ms=main["ms"], kernel_ms=main["ms"], timer=main["timer"],
                host_us=main["host_us"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shape=main["shape"], **extra)


def main(argv) -> int:
    t_start = time.perf_counter()
    import torch
    card = phase_device()
    phase_build()
    kernels_only = "--kernels-only" in argv
    # the main path runs before the kernels are timed: torch.profiler, which
    # times them, leaves tracing attached that slows the host-bound
    # sampler's wall time afterwards
    launches = trained = None
    if not kernels_only:
        launches, req_b = phase_main_path(card)
        got, trained = phase_training(card)
        for k, v in got.items():
            launches[k] += v
        got, scaled = phase_scale_out(card, req_b)
        for k, v in got.items():
            launches[k] += v
    att, att8, att_bwd, rst, mm = phase_kernels()
    att_train = training_cases()
    att_shard, mm_partial = scale_out_cases()
    if kernels_only:
        # the kernels alone, to time two trees' kernels in one call
        print(json.dumps({"cases": dict(attention=att, attention_kv8=att8,
                                        attention_backward=[att_bwd],
                                        attention_training=list(att_train),
                                        attention_shard=att_shard,
                                        res_stack=rst, int8_matmul=mm,
                                        int8_matmul_partial=mm_partial)}),
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
            ":105 (_flash_kernel)", att + att8 + [att_train[0]] + att_shard,
            att[0],
            launches["joint_attention"] + launches["joint_attention_kv8"],
            launches_bf16=launches["joint_attention"],
            launches_kv8=launches["joint_attention_kv8"],
            kv8=summary(att8[0]),
            # request h's CFG step (GB = 24 over a KV batch of 8)
            kv_batch8=summary(next(r for r in att if " B=8" in r["shape"])),
            # request (i)'s shapes: the forward under grad, and the forward
            # with the plain recompute's backward; launches per train step
            # in each remat mode (its recompute re-runs the forward under
            # "full" and "dots")
            train_forward=summary(att_train[0]),
            # request (k)'s teacher and request (m)'s demo on CFG steps
            teacher=summary(next(r for r in att if r["shape"].startswith(
                "GB=6 S=640 T=928"))),
            demo=summary(next(r for r in att if r["shape"].startswith(
                "GB=3 S=640 T=928"))),
            train_backward=summary(att_train[1]),
            # requests (n) and (o): a tensor-parallel rank's heads at
            # request (b)'s shape (8 at tp = 2, 4 at tp = 4)
            shard_h8=summary(att_shard[0]), shard_h4=summary(att_shard[1]),
            # request (r)'s last block, on CFG steps and else
            soak_last_block=summary(next(r for r in att if r["shape"]
                                         .startswith("GB=3 S=320 T=2208"))),
            soak_last_block_gb1=summary(next(
                r for r in att if r["shape"].startswith("GB=1 S=320 T=2208"))),
            launches_per_train_step={
                mode: r["launches_per_step"]
                for mode, r in trained["train"].items()},
            backward=summary(att_bwd) | {
                k: att_bwd[k] for k in ("host_us_no_grad_launch",
                                        "host_us_no_grad_function",
                                        "host_us_function_cost",
                                        "host_us_function_cost_quartiles")}),
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
            stream=summary(rst_stream, "unrolled_ms"),
            # request h's decode slice at the decoder's last block
            batch4=summary(next(r for r in rst if "batch 4" in r["shape"]),
                           "unrolled_ms")),
        # M=1920 (a CFG step), w1/w3 (2048 -> 5888); max_abs_err is the
        # fp32 output's
        kernel_entry(
            "int8_matmul", "echo_tts_torch/csrc/int8_matmul.cu",
            "echo_tts_tpu/ops/pallas/int8_matmul.py:44 (_kernel)", mm, mm[0],
            launches["int8_matmul"],
            max_abs_err_bf16=max(r["max_abs_err_bf16"] for r in mm),
            prepass_ms=mm[0]["prepass_ms"],
            bf16_matmul_ms=mm[0]["bf16_matmul_ms"]),
        # the row-parallel instance at request (o)'s w2 slice (M = 1920, K =
        # 5888 / 2); its int32 sums are held exactly (max_abs_err 0)
        kernel_entry(
            "int8_matmul_row_parallel", "echo_tts_torch/csrc/int8_matmul.cu",
            "echo_tts_tpu/ops/pallas/int8_matmul.py:44 (_kernel), as GSPMD "
            "splits the JAX package's int8_dot over a sharded K "
            "(echo_tts_tpu/ops/quant.py:65)", mm_partial, mm_partial[1],
            launches["int8_matmul_partial"],
            wo=summary(mm_partial[0]), prepass_ms=mm_partial[1]["prepass_ms"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
