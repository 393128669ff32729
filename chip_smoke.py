#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (echo_tts_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. device: CUDA must be present; prints the card's name and power limit;
     TF32 off for matmuls and cuDNN (cuDNN convs default to TF32, which
     would blur the plain versions the kernels are held against);
  2. build both hand-written kernels from csrc/ (one nvcc each, in
     parallel) and print the build seconds and ptxas's report;
  3. each kernel against its plain PyTorch version on the card, in bf16,
     at the main path's shapes (and, for the residual stack, at blocks
     shorter than one tile): max-abs and rel-RMS error against the bound
     rel-RMS <= 1e-2 (for the residual stack also over the first tile
     alone), kernel / plain / library times and the card's bound for the
     same work;
  4. the main path at full width with seeded random weights: three
     requests (no speaker; tests/data/voice.wav as speaker; a two-chunk
     text with that voice) through sample_pipeline /
     sample_pipeline_chunked, checking the audio and the kernels' launch
     counts, with stage times and RTF;
  5. one {"kernels": [...]} line; 6. the last line {"ok": true, ...}.
Imports nothing of JAX or of echo_tts_tpu.
"""
from __future__ import annotations

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

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores
# and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
REL_RMS_BOUND = 1e-2   # bf16 kernel vs plain (PARITY.md: bf16 vs fp32 1.05e-2)

VOICE = os.path.join(REPO, "tests", "data", "voice.wav")
TEXT = ("The quick brown fox jumps over the lazy dog, then reads it a "
        "bedtime story.")
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


def timed(fn, reps: int) -> float:
    """Mean ms per call on the card (CUDA events, after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def errors(got, want) -> tuple:
    """(max-abs, rel-RMS) of a kernel's output against its plain version;
    raises on a non-finite output."""
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError("kernel output has non-finite values")
    max_abs = float((g - w).abs().max())
    rel_rms = float(((g - w).pow(2).mean().sqrt()) / w.pow(2).mean().sqrt())
    return max_abs, rel_rms


def bound(flops: float, nbytes: float) -> tuple:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
        cuda_build.load(name)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_case(gb: int, s: int, t: int, seed: int):
    import torch
    from echo_tts_torch.ops import joint_attention as ja
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
    text[:min(n_text, t_text)] = True
    spk = torch.zeros((t,), dtype=torch.bool, device=dev)
    spk[t_text:] = True
    cond = text | spk
    rows = [cond, spk, text][:gb] if gb == 3 else [cond] * gb
    mask = torch.stack(rows)          # CFG branches blank whole segments
    col_scale = torch.where(spk, 1.5, 1.0).float()
    sm = dh ** -0.5

    ja.fused_joint_attention.launches = 0
    out = ja.fused_joint_attention(q, ks, vs, kt, vt, mask, col_scale,
                                   sm_scale=sm)
    torch.cuda.synchronize()
    ref = ja.joint_attention_plain(q, ks, vs, kt, vt, mask, col_scale,
                                   sm_scale=sm)
    max_abs, rel = errors(out, ref)
    if rel > REL_RMS_BOUND:
        raise AssertionError(f"joint attention GB={gb} S={s} T={t}: rel-RMS "
                             f"{rel:.3e} > {REL_RMS_BOUND}")
    kernel_ms = timed(lambda: ja.fused_joint_attention(
        q, ks, vs, kt, vt, mask, col_scale, sm_scale=sm), 50)
    plain_ms = timed(lambda: ja.joint_attention_plain(
        q, ks, vs, kt, vt, mask, col_scale, sm_scale=sm), 5)
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
        qb, kb, vb, attn_mask=am, scale=sm), 50)
    flops = 4.0 * gb * h * s * (s + t) * dh
    nbytes = 4 * gb * s * h * dh * 2 + 2 * b * t * h * dh * 2 + gb * t + t * 4
    b_ms, b_by = bound(flops, nbytes)
    ja.fused_joint_attention.launches = 0
    res = dict(shape=f"GB={gb} S={s} T={t} H={h} Dh={dh}", max_abs_err=max_abs,
               rel_rms=rel, ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"  attention {res['shape']}: max_abs {max_abs:.3e} rel_rms {rel:.3e}"
        f" (bound {REL_RMS_BOUND}) kernel_ms {kernel_ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by})")
    return res


def res_stack_case(c: int, length: int, approx: bool, seed: int):
    import torch
    from echo_tts_torch.ops import res_stack as rs
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape, std):
        return (torch.randn(shape, generator=g, device=dev) * std).to(torch.bfloat16)

    x = rnd((1, length, c), 0.5)
    w1 = rnd((3, 7, c, c), (7 * c) ** -0.5)
    w2 = rnd((3, c, c), c ** -0.5)
    # biases large enough that a kernel which let the context before the
    # sequence start drift from zero would miss the bound on the first
    # tile (tests/test_torch_res_stack.py holds that margin)
    b1, b2 = rnd((3, c), 0.1), rnd((3, c), 0.1)
    a1 = (1.0 + 0.1 * torch.randn((3, c), generator=g, device=dev)).to(torch.bfloat16)
    a2 = (1.0 + 0.1 * torch.randn((3, c), generator=g, device=dev)).to(torch.bfloat16)
    args = (w1, b1, a1, w2, b2, a2)
    weights = rs.ResStackWeights(*args)

    rs.fused_res_stack.launches = 0
    out = rs.fused_res_stack(x, weights, approx_snake=approx)
    torch.cuda.synchronize()
    ref = rs.res_stack_plain(x, *args, approx_snake=approx)
    max_abs, rel = errors(out, ref)
    # the first block's frames on their own: zeroing the context before the
    # sequence start after each unit touches only these, and the whole-L
    # error would dilute a fault there below any bound
    head = rs.HALO + rs.block_length(weights.kernel_layout()[0])
    _, rel_head = errors(out[:, :head], ref[:, :head])
    if rel > REL_RMS_BOUND or rel_head > REL_RMS_BOUND:
        raise AssertionError(f"res stack C={c} L={length} approx={approx}: "
                             f"rel-RMS {rel:.3e}, first {head} frames "
                             f"{rel_head:.3e}, bound {REL_RMS_BOUND}")
    reps = 5 if length > 4096 else 50
    kernel_ms = timed(lambda: rs.fused_res_stack(x, weights, approx_snake=approx),
                      reps)
    plain_ms = timed(lambda: rs.res_stack_plain(x, *args, approx_snake=approx),
                     max(3, reps // 5))
    flops = 3 * 2.0 * 8 * c * c * length
    nbytes = 2 * length * c * 2 + 3 * 8 * c * c * 2 + 3 * 4 * c * 2
    b_ms, b_by = bound(flops, nbytes)
    rs.fused_res_stack.launches = 0
    res = dict(shape=f"C={c} L={length} snake={'sin2_poly' if approx else 'exact'}",
               max_abs_err=max_abs, rel_rms=max(rel, rel_head), ms=kernel_ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)
    log(f"  res_stack {res['shape']}: max_abs {max_abs:.3e} rel_rms {rel:.3e}"
        f" first {head} frames {rel_head:.3e} (bound {REL_RMS_BOUND}) kernel_ms {kernel_ms:.4f} plain_ms "
        f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
    return res


def phase_kernels():
    log("phase 3: kernels vs plain (bf16)")
    att = [attention_case(gb, 640, t, seed=i) for i, (gb, t) in enumerate(
        [(3, 778), (1, 778), (3, 2368), (1, 2368)])]
    att.append(attention_case(3, 1280, 778, seed=9))
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
    return att, rst


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def phase_main_path():
    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.ops.joint_attention import fused_joint_attention
    from echo_tts_torch.ops.res_stack import fused_res_stack
    from echo_tts_torch.pipeline import audio_io, pipeline as pl
    from echo_tts_torch.pipeline.text import chunk_text, get_text_input_ids_and_mask

    log("phase 4: main path (full width, seeded random weights)")
    t0 = time.perf_counter()
    models = pl.random_models()
    torch.cuda.synchronize()
    log(f"  random_models: {time.perf_counter() - t0:.1f} s, DiT "
        f"{sum(p.numel() for p in models.dit.parameters()) / 1e9:.3f} B params, "
        f"codec {sum(p.numel() for p in models.dac.parameters()) / 1e9:.3f} B")
    cfg = models.dit_cfg
    n_layers, n_steps = cfg.num_layers, SAMPLER_DEFAULTS["num_steps"]
    sample_fn = functools.partial(pl.euler_sample_fn, **SAMPLER_DEFAULTS)
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

    def timed_sample_fn(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sample_fn(*a)
        torch.cuda.synchronize()
        stage["sampler"].append((time.perf_counter() - t) * 1e3)
        return out

    def timed_decode(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(*a)
        torch.cuda.synchronize()
        stage["decode"].append((time.perf_counter() - t) * 1e3)
        return out

    pl.dsp.crop_audio_to_flattening_point = recording_crop
    pl.ae_decode = timed_decode
    requests = [
        ("a: sample_pipeline, no speaker", lambda: pl.sample_pipeline(
            models, timed_sample_fn, TEXT, None, 0), 1, 0),
        ("b: sample_pipeline, voice.wav", lambda: pl.sample_pipeline(
            models, timed_sample_fn, TEXT, voice, 1), 1, n_voice_chunks),
        ("c: sample_pipeline_chunked, 2 chunks, voice.wav",
         lambda: pl.sample_pipeline_chunked(
             models, timed_sample_fn, LONG_TEXT, voice, 2), 2, n_voice_chunks),
    ]
    launches = {"joint_attention": 0, "res_stack": 0}
    try:
        for name, run, n_samples, n_enc in requests:
            fused_joint_attention.launches = 0
            fused_res_stack.launches = 0
            n_dec = len(decoded)
            torch.cuda.synchronize()
            t = time.perf_counter()
            audio, _ = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            attn, rst = fused_joint_attention.launches, fused_res_stack.launches
            launches["joint_attention"] += attn
            launches["res_stack"] += rst
            want_attn = n_layers * n_steps * n_samples
            want_rs = 3 * n_samples + 3 * n_enc
            if attn != want_attn or rst != want_rs:
                raise AssertionError(
                    f"{name}: launches attention {attn} (want {want_attn}), "
                    f"res_stack {rst} (want {want_rs})")
            for shape, finite, peak in decoded[n_dec:]:
                if shape != (1, 640 * spl) or not finite or peak <= 1e-4:
                    raise AssertionError(f"{name}: decoded {shape} finite "
                                         f"{finite} peak {peak}")
            if audio.ndim != 2 or audio.shape[1] == 0 or not np.isfinite(audio).all():
                raise AssertionError(f"{name}: audio {audio.shape}")
            secs = audio.shape[1] / models.dac_cfg.sample_rate
            log(f"  request {name}: {wall * 1e3:.1f} ms wall, {secs:.2f} s "
                f"audio, RTF {secs / wall:.3f}x realtime; launches attention "
                f"{attn} res_stack {rst}; sampler_ms "
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

    def prefill():
        with torch.inference_mode():
            kv_t = tdit.get_kv_cache_text(models.dit, ids_t, tmask_t)
            kv_s = tdit.get_kv_cache_speaker(models.dit, lat_t)
            return tdit.concat_static_kv(kv_t, kv_s)

    prefill_ms = timed(prefill, 3)
    log(f"  stage ms (request b shapes): prefill {prefill_ms:.1f}, sampler "
        f"(incl. prefill) {stage['sampler'][1]:.1f}, decode "
        f"{stage['decode'][1]:.1f}")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch
    phase_device()
    phase_build()
    att, rst = phase_kernels()
    launches = phase_main_path()
    main_att = att[0]                 # GB=3, S=640, T=778: request b's shape
    main_rs = rst[0]                  # C=96 with the serving decoder's snake
    kernels = [
        dict(name="joint_attention", route="cuda",
             source="echo_tts_torch/csrc/joint_attention.cu",
             replaces="echo_tts_tpu/ops/pallas/joint_attention.py:53 "
                      "(_kernel) and :105 (_flash_kernel)",
             launches=launches["joint_attention"],
             max_abs_err=max(r["max_abs_err"] for r in att),
             rel_rms=max(r["rel_rms"] for r in att),
             ms=main_att["ms"], kernel_ms=main_att["ms"],
             plain_ms=main_att["plain_ms"], bound_ms=main_att["bound_ms"],
             bound_by=main_att["bound_by"], library_ms=main_att["library_ms"],
             shape=main_att["shape"]),
        dict(name="res_stack", route="cuda",
             source="echo_tts_torch/csrc/res_stack.cu",
             replaces="echo_tts_tpu/ops/pallas/res_stack.py:60 "
                      "(_res_stack_kernel)",
             launches=launches["res_stack"],
             max_abs_err=max(r["max_abs_err"] for r in rst),
             rel_rms=max(r["rel_rms"] for r in rst),
             ms=main_rs["ms"], kernel_ms=main_rs["ms"],
             plain_ms=main_rs["plain_ms"], bound_ms=main_rs["bound_ms"],
             bound_by=main_rs["bound_by"], library_ms=None,
             shape=main_rs["shape"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
