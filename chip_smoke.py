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
     recorded and the measured stream's launches exact, and the drain's
     timing (the first later block under 1.5 and the last above 0.5 times
     the median block: no chunk waits for the next block); (s)
     tools/check_fullsize.check, the full-depth CFG forward in bf16 within
     rel-RMS 0.05 and max-abs 0.30 of fp32, the W8A8 forward beside it;
     then the measurement modules (echo_tts_torch/examples/bench_*.py,
     given phase 3's models, one timed call a stage, each one JSON line
     with its numbers finite and its launches exact; the sampler-bound
     ones, (t), (u) and (w)'s long reference, stream int8 and latent
     prefix, at CHECK_STEPS = 8 Euler steps, depth cut for time): (t)
     bench_kv_quant --long-speaker --w4a8, the sampler at B = 1 and at
     B = 8 over the 6400-latent speaker bucket with bf16 and int8 static
     K/V (kernel A at GB = 24 and 8, T = 2368; the K/V sizes those of 24 x
     2 x 8 x 2368 x 2048 values) and the M = 120 scan in W8A8 and W4A8;
     (u) bench_int8_surfaces, the W8A8 request at seq 224 and one B = 8
     run_batch pass (kernel C at M = 15360 and 5120); (v)
     bench_train_step --sweep --remats attn from B = 2 to 16 or the
     first out-of-memory point (in the eager run or in the capture of
     the value-and-grad step's program), a warm-up call (eager run and
     capture) and a timed replay a point, 24 kernel A launches a step,
     its FLOP count the JAX script's; (w) the other seven (long reference, few
     step, stream int8, TTFA breakdown, the latent prefix over a
     640-latent stream, the attention sweep, the int8 scans); (x)
     tools/validate_weights.main --no-reference --int8-report on those
     models written as the published files: exit 0, its legs passed,
     every number finite, kernels A, B and C launched exactly (2304, 6,
     9216; request_validate gives the arithmetic) at the shapes phase 4
     holds (VALIDATE_*: kernel A at T = 40, under one static tile); (y)
     echo_tts_torch.bench.main (the headline bench) with one warm-up and
     one timed call a stage: its line with bench.py's 15 keys, card and
     ranges, every number finite and above 0, each stage's launches of
     kernels A, B (one-shot and history form) and C exact and their shapes
     those phase 4 holds (bench_expected gives the arithmetic: kernel A at
     T = 928 for the one-shot stages and the B = 8 pass at GB = 24 and 8,
     T = 1248 for the streamed blocks after the first), its line printed
     on a line of its own; (z) the compiled-program layer
     (echo_tts_torch/utils/programs.py: the sampler, the codec and the
     bench's stages as one CUDA graph per key and shape, which every
     request above already ran through, their launch counts exact under
     replay): request (b)'s inputs in bf16, with int8 static K/V, and in
     request (d)'s int8 modes, replayed bit for bit their eager run, and a second
     input set at the same key bit for bit its own eager run; the streams
     as programs (the fused first block, the later blocks with their start
     an input tensor, the prefix's appends, the block decodes), at 40 steps
     a block: (y)'s 1240-latent stream (whose replay (y) holds bit for bit
     against its eager warm-up) and (g)'s W8A8 stream replayed bit for bit
     their eager runs, a second text and seed bit for bit its own, one
     later-block program per block size ((e)'s is (q)'s); the
     default
     warm-up manifest with batch_sizes=(8,) through
     serve.handler.warmup_compile, each entry's capture seconds, the
     shared pool's and the static inputs' bytes and memory_reserved, then
     a second pass that captures nothing, its streams included, and
     reserves no more (request_programs says each gate);
     then training at the published
     depth, seeded random weights: (i) train.loop.train at B = 2 on one
     batch of the DataConfig shapes, t and eps fixed, an EMA, three steps
     in each remat mode (none, full, dots, dots_all, attn) through the
     train step's program (one CUDA graph: loss, backward, clip, AdamW,
     EMA): the first step its eager run with host syncs made errors
     (torch.cuda.set_sync_debug_mode) and its capture (seconds, host RSS,
     pool bytes), the next two replays, each step's kernel A launches
     exact (24, or 48 where the recompute re-runs the forward), step ms,
     peak memory, each mode's gradients within rel-RMS 1e-2 of "none"'s,
     the first-step losses within 1e-3, the loss lower at step 3, and the
     three steps' losses, parameters and EMA bit for bit those of the
     step's body called eagerly; kernel A's step against the plain
     version's and against the fp32 step at the bf16 step's timestep
     (within GRAD_FP32_RATIO of the plain bf16 step's distance); AdamW's
     capturable update against the CPU's form (reported); the device
     clip on bf16 gradients bit for bit the host float's; one step at
     blockwise=True (the latent encoder decayed without a gradient); (j)
     write_shards on voice.wav (kernel B) feeding one step through
     iter_batches; (k) three distill steps, 8 student steps of 5 teacher
     substeps, plain and quant-aware, through the distill step's program
     as (i)'s, bit for bit its body's; (l) the student's bundle
     saved and loaded through serve.models.load_models bit for bit, then a
     handler job with few_step_sampler_params(8) in bf16 and under
     ECHO_DIT_QUANT=int8; (m) one DemoSession.generate_audio, bit for bit
     sample_pipeline's; then scale-out (echo_tts_torch/parallel/): (n)
     request (b) again at world size 1, through initialize_from_env (NCCL
     on localhost), global_mesh(tp=1), shard_models and place_request:
     the mesh sampler's body without its program (`.eager`), then its
     program's miss and a replay, each call's latents bit for bit (b)'s
     and 960 kernel A launches, with their wall ms; a program whose body
     runs NCCL's all_reduce and all_gather_into_tensor on the one-rank
     world, replayed equal to its eager body; three steps of the mesh
     train program at TRAIN_DEPTH layers bit for bit three of `.eager`
     (loss, parameters, AdamW moments, EMA); then (b)'s inputs through the
     fp32 sampler (plain attention); (o) two ranks on the one card
     (torch.multiprocessing spawn, a gloo world: NCCL refuses two ranks on
     one device, and no graph captures gloo's collectives): rank 0 first
     checks that the mesh sampler's program refuses the gloo mesh on the
     card, naming the backend; then each rank, through the mesh cores'
     `.eager` forms, builds the published DiT and its own unsharded
     references: SP tp=2 at 6400 latents, DP=2 on a B = 2
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
     a yardstick; kernel A at request (t)'s B = 8 shapes (GB = 24 and 8,
     T = 2368, bf16 and int8 K/V) and kernel C at request (u)'s (M =
     15360 and 5120, each (K, N)) and (t)'s (M = 120, K = 2048, N =
     5888); kernel A at request (y)'s B = 8 pass (GB = 24 and 8, T = 928,
     200 text columns valid) and its streamed blocks (GB = 3 and 1, S =
     320 and 80, T = 1248 with 230 and 10 of 320 latent columns valid)
     and request (g)'s (GB = 3 and 1, S = 80, T = 1008 with 10 of 80),
     and kernel B at (y)'s decode, batch-4 and streamed-block shapes that
     no other case holds;
  5. one {"kernels": [...]} line; 6. the last line {"ok": true, ...}.
With --kernels-only it skips phase 3 and prints one {"cases": ...} line
after phase 4 instead, so that two trees' kernels can be timed in one call.
With --programs-only it runs request (b), then request (z) alone, and
prints one {"programs": ...} line.
Imports nothing of JAX or of echo_tts_tpu.
"""
from __future__ import annotations

import contextlib
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

from echo_tts_torch.utils.profiling import (  # noqa: E402
    PEAK_INT8_OPS, bound, host_us_paired, timed)

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
# request (r)'s drain: the first later block under SOAK_FIRST_LATER_MAX
# times the median block, the last above SOAK_LAST_MIN times it
SOAK_FIRST_LATER_MAX, SOAK_LAST_MIN = 1.5, 0.5
# request (g)'s later block: 320 / 4 latent, 768 text and 640 / 4 speaker
# columns
G_STREAM_T = 80 + 768 + 160
# request (x), tools/validate_weights at its defaults: sequence 160 over 24
# text bytes (20 valid) and 64 speaker latents (16 patches), so kernel A's
# static K/V is T = 40 columns, under one 128-column tile, at GB = 3 on CFG
# steps and 1 else; kernel C at M = GB x 160 for the W8A8 DiT's three
# (K, N); kernel B at the 32-latent round trip's stacks, (C, L, sin2_poly):
# the encoder's first three (exact sin), the decoder's last three
VALIDATE_S, VALIDATE_TEXT, VALIDATE_TEXT_VALID, VALIDATE_SPEAKER = 160, 24, 20, 16
VALIDATE_ATTN = {(gb, VALIDATE_S, VALIDATE_TEXT + VALIDATE_SPEAKER)
                 for gb in (3, 1)}
DIT_INT8_KN = ((2048, 5888), (2048, 2048), (5888, 2048))
VALIDATE_MM = {(gb * VALIDATE_S, k, n) for gb in (3, 1) for k, n in DIT_INT8_KN}
VALIDATE_RES = {(64, 65536, False), (128, 32768, False), (256, 8192, False),
                (384, 8192, True), (192, 32768, True), (96, 65536, True)}
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


def log(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.perf_counter()


def stamp(what: str) -> None:
    """Log the seconds since the script started, after `what`."""
    log(f"  [{time.perf_counter() - _T0:.1f} s] {what} done")


def errors(got, want) -> tuple:
    """(max-abs, rel-RMS) of a kernel's output against its plain version;
    raises on a non-finite output."""
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError("kernel output has non-finite values")
    max_abs = float((g - w).abs().max())
    rel_rms = float(((g - w).pow(2).mean().sqrt()) / w.pow(2).mean().sqrt())
    return max_abs, rel_rms


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


# The sampler, the codec's encode and decode and the bench's stages run as
# captured programs (echo_tts_torch/utils/programs.py): a program's first
# call runs eagerly, then its capture calls the kernels' wrappers without
# launching anything, and its replays launch them without calling Python.
# The launch counters stay exact (the programs add each replay's
# launches); the requests below that record the wrappers' calls by shape
# do so through `note`, which a program's capture keeps and each of its
# replays runs, and read tensor values only outside a capture.
_CAPTURE_NOTES = None


def capturing() -> bool:
    import torch
    return torch.cuda.is_current_stream_capturing()


def note(record) -> None:
    """record() for a call made now, outside a capture; during a program's
    capture, kept and run on each of the program's replays instead."""
    if _CAPTURE_NOTES is not None and capturing():
        _CAPTURE_NOTES.append(record)
    else:
        record()


# (cache name, the host's resident bytes before the capture, after it)
CAPTURE_RSS = []


def host_rss() -> int:
    """This process's resident host memory, bytes (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def install_program_notes() -> None:
    """Let programs keep the notes their captures take (`note`); record
    each capture's host memory (CAPTURE_RSS)."""
    from echo_tts_torch.utils import programs
    prog = programs.Program
    capture, run = prog.capture, prog.run

    def noting_capture(self, owner, device, name):
        global _CAPTURE_NOTES
        _CAPTURE_NOTES = []
        rss = host_rss()
        try:
            capture(self, owner, device, name)
        finally:
            self.notes, _CAPTURE_NOTES = _CAPTURE_NOTES, None
            CAPTURE_RSS.append((name, rss, host_rss()))

    def noting_run(self, *a, **k):
        out = run(self, *a, **k)
        if self.graph is not None:
            for record in getattr(self, "notes", ()):
                record()
        return out

    prog.capture, prog.run = noting_capture, noting_run


# the streams' program caches (sampler/blockwise.py, pipeline.py,
# serve/streaming.py)
STREAM_CACHES = ("prefill", "latent_inc", "block", "fused_first",
                 "decode_block", "encode_block")


def stream_misses() -> int:
    """The streams' program caches' misses so far (each a capture)."""
    from echo_tts_torch.utils import programs
    return sum(c.misses for c in programs.caches() if c.name in STREAM_CACHES)


def fresh_programs(streams: bool = True) -> None:
    """Drop every program (with streams=False every one but the streams'),
    so that the next call at each key runs eagerly (and is recorded as it
    runs); the pool's memory is returned."""
    import torch
    from echo_tts_torch.utils import programs
    for cache in programs.caches():
        if streams or cache.name not in STREAM_CACHES:
            cache.clear()
    torch.cuda.empty_cache()


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
                   n_text: int = 96, t_text: int = 768):
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
    tensor-parallel rank's).  n_text: the valid text columns of the
    t_text (96, a short prompt's bytes; 768, a prompt that fills them;
    t_text 24, a text of 24 bytes unpadded, as validate_weights feeds)."""
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
    latent += f" of {t_text}" if t_text != 768 else ""
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


def res_shape(c: int, length: int, approx: bool) -> str:
    return f"C={c} L={length} snake={'sin2_poly' if approx else 'exact'}"


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
    res = dict(shape=res_shape(c, length, approx)
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
    res = dict(shape=res_shape(c, length, approx) + " history",
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
                       (1, 80, 938, 160, 10), (3, 320, 1098, 320, 70),
                       # request (g)'s later block: [40, 80] padded to the
                       # 320-latent bucket, 80 latent columns (10 valid),
                       # the voice padded to its 640-latent bucket
                       (3, 80, G_STREAM_T, 80, 10), (1, 80, G_STREAM_T, 80, 10)])]
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
    # request (t)'s B = 8 pass over the 6400-latent speaker bucket: T = 768
    # text (200 valid) + 1600 speaker columns, GB = 24 on CFG steps and 8
    # else, with bf16 and with int8 static K/V
    att_long = [attention_case(gb, 640, 2368, seed=140 + i, kv8=kv8, b=8,
                               n_text=200)
                for i, (gb, kv8) in enumerate([(24, False), (8, False),
                                               (24, True), (8, True)])]
    att += att_long[:2]
    att8 += att_long[2:]
    # request (u)'s short W8A8 request (seq 224 over the 640-latent
    # speaker: T = 768 + 160, 200 text columns valid) and request (w)'s
    # 2816-latent speaker bucket (bench_long_reference: five 640-latent
    # chunks encoded, 2816 latents valid, so T = 768 + 800 with 704 speaker
    # columns valid), each at GB = 3 on CFG steps and 1 else
    att += [attention_case(gb, s, t, seed=150 + i, n_text=200,
                           spk_lens=lens)
            for i, (gb, s, t, lens) in enumerate(
                [(3, 224, 928, None), (1, 224, 928, None),
                 (3, 640, 1568, [704]), (1, 640, 1568, [704])])]
    # request (x)'s: T = 40 static columns (VALIDATE_*), under one tile
    att += [attention_case(gb, s, t, seed=160 + gb, n_text=VALIDATE_TEXT_VALID,
                           t_text=VALIDATE_TEXT)
            for gb, s, t in sorted(VALIDATE_ATTN, reverse=True)]
    # request (y)'s: the B = 8 pass at T = 928 (200 of 768 text columns and
    # all 160 speaker columns valid), GB = 24 and 8; the streamed blocks
    # after the first at T = 1248 (BENCH_LAT latent-prefix columns, 230
    # valid at the last block of 320 and 10 at the block of 80; the text
    # columns STREAM_TEXT's), GB = 3 and 1
    att_bench = [attention_case(gb, 640, BENCH_T, seed=190 + i, b=8,
                                n_text=BENCH_TEXT_VALID)
                 for i, gb in enumerate((24, 8))]
    text_stream = stream_text_valid()
    att_bench += [attention_case(gb, s, BENCH_STREAM_T, seed=192 + i,
                                 n_lat=BENCH_LAT, lat_valid=valid,
                                 n_text=text_stream)
                  for i, (gb, s, valid) in enumerate(
                      [(3, 320, 230), (1, 320, 230), (3, 80, 10), (1, 80, 10)])]
    att += att_bench
    # kernel A under grad (the autograd Function, backward by recompute)
    att_bwd = attention_backward_case(3, 640, 778, seed=104)
    att8 += [r for r in edges[:4] if "int8" in r["shape"]]
    att += [r for r in edges[:4] if "int8" not in r["shape"]]
    # every (M, K, N) the W8A8 DiT gives kernel C: M = 1920 on CFG steps
    # (GB=3), 640 else; wq/wk/wv/gate/wo (2048, 2048), w1/w3 (2048, 5888),
    # w2 (5888, 2048); request (u)'s B = 8 pass (M = 24 x 640 = 15360 on
    # CFG steps, 8 x 640 = 5120 else) and its short request (M = 3 x 224 =
    # 672 on CFG steps, 224 else); request (t)'s M = 120 scan, the
    # streaming first block's rows (3 x 40) at w1's shape; request (x)'s
    # M = 480 on CFG steps and 160 else
    mm = [int8_matmul_case(m, k, n, seed=40 + i) for i, (m, k, n) in enumerate(
        [(1920, 2048, 5888), (1920, 2048, 2048), (1920, 5888, 2048),
         (640, 2048, 5888), (640, 2048, 2048), (640, 5888, 2048),
         (15360, 2048, 5888), (15360, 2048, 2048), (15360, 5888, 2048),
         (5120, 2048, 5888), (5120, 2048, 2048), (5120, 5888, 2048),
         (672, 2048, 5888), (672, 2048, 2048), (672, 5888, 2048),
         (224, 2048, 5888), (224, 2048, 2048), (224, 5888, 2048),
         (120, 2048, 5888)])]
    mm += [int8_matmul_case(m, k, n, seed=170 + i) for i, (m, k, n) in
           enumerate(sorted(VALIDATE_MM, reverse=True))]
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
    # request (x)'s 32-latent round trip (VALIDATE_RES)
    rst += [res_stack_case(c, length, approx, seed=180 + i)
            for i, (c, length, approx) in enumerate(sorted(VALIDATE_RES))]
    # the history form at the decoder's shapes for blocks of 40 and 320
    # latents (L = 256, 1024, 2048 frames a latent at C = 384, 192, 96),
    # with sin2_poly, and an encoder-side shape (C = 64) with exact sin
    rst += [res_stack_history_case(c, length, approx, seed=80 + i)
            for i, (c, length, approx) in enumerate(
                [(384, 10240, True), (192, 40960, True), (96, 81920, True),
                 (384, 81920, True), (192, 327680, True), (96, 655360, True),
                 (64, 2048, False)])]
    # request (y)'s kernel B and C shapes (bench_expected) that no case
    # above holds: the short request's decode (224 latents), the B = 8
    # decode slices at C = 192, the history form at the blocks of 80 and
    # 160 latents
    held = {r["shape"] for r in rst}
    for i, (shape, (c, length, approx, batch, hist)) in enumerate(
            sorted(bench_res_shapes().items())):
        if shape not in held:
            rst.append(res_stack_history_case(c, length, approx, seed=200 + i)
                       if hist else res_stack_case(c, length, approx,
                                                   seed=200 + i, batch=batch))
    held = {r["shape"] for r in mm}
    mm += [int8_matmul_case(m, k, n, seed=230 + i) for i, (m, k, n) in
           enumerate(sorted(set().union(*(
               e[3] for e in bench_expected(1, 1, 1).values()))))
           if f"M={m} K={k} N={n}" not in held]
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

    stamp("requests a-d")
    got, stream_audio = request_stream(models, voice, counters, n_voice_chunks)
    for k, v in got.items():
        launches[k] += v
    stamp("request e")
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
    stamp("requests f-h")

    # the runnable entry points: (p) generate, (q) streaming_demo, (r) the
    # long-stream soak, (s) the full-depth bf16 forward against fp32
    for req, call in (
            ("p", lambda: request_generate(models, counters, n_layers,
                                           n_voice_chunks)),
            ("q", lambda: request_stream_demo(models, counters, stream_audio,
                                              n_layers, n_voice_chunks)),
            ("r", lambda: request_soak(models, counters, card)),
            ("s", lambda: request_fullsize(models, counters, n_layers,
                                           n_int8_linears))):
        for k, v in call().items():
            launches[k] += v
        stamp(f"request {req}")
    # the measurement modules: (t) int8 static K/V at B = 8 over the
    # 6400-latent bucket and the M = 120 scan, (u) the W8A8 surfaces, (v)
    # the train step's batch sweep, (w) the other seven
    for k, v in request_benches(models, counters, card).items():
        launches[k] += v
    # (x) the weight-validation gate on these models' files
    for k, v in request_validate(models, counters, n_layers,
                                 n_int8_linears).items():
        launches[k] += v
    stamp("request x")
    # (y) the headline bench
    for k, v in request_bench(models, counters, card).items():
        launches[k] += v
    stamp("request y")
    # (z) the compiled-program layer
    for k, v in request_programs(models, req_b, counters, card).items():
        launches[k] += v
    stamp("request z")
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
    from echo_tts_torch.device import no_tf32
    from echo_tts_torch.tools.stream_checks import decode_pair

    schedule = growing_schedule(STREAM_TOTAL)
    cfg = models.dit_cfg
    spl, rate = models.dac_cfg.frame_length, models.dac_cfg.sample_rate
    blocks, decode_ms = [], []
    block_decode = sst.ae_decode_block
    iterate = sst.bw.iter_blockwise_euler_cfg_independent_guidances

    def recording_decode(m, state, latents):
        # the decode's own wall time (the blocks after the first: the
        # first decodes inside the fused first-block program)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = block_decode(m, state, latents)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def recording_blocks(*a, **k):
        # the latents of every block, the fused first one's included
        for out in iterate(*a, **k):
            blocks.append(out[1].clone())
            yield out

    _reset(counters)
    sst.ae_decode_block = recording_decode
    sst.bw.iter_blockwise_euler_cfg_independent_guidances = recording_blocks
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
        sst.bw.iter_blockwise_euler_cfg_independent_guidances = iterate
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
        f"first audio; decode_ms per block after the first "
        f"{[round(v, 1) for v in decode_ms]}")
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
        key = (q.shape[0], a[2].shape[0])
        note(lambda: attn_rows.update([key]))
        return run_attention(q, *a, **k)

    def recording_res_stack(x, *a, **k):
        rows = x.shape[0]
        note(lambda: res_rows.append(rows))
        return run_res_stack(x, *a, **k)

    # the streams' programs stay: request (q) replays request (e)'s
    fresh_programs(streams=False)
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
    exactly (e)'s chunks concatenated, its stream replaying the programs
    (e)'s eager run captured; launches as (e)'s.  Returns the launch
    counts."""
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
    <= 1.5, memory_allocated growth <= 256 MB, 5120 x 2048 finite samples;
    the first later block under SOAK_FIRST_LATER_MAX and the last above
    SOAK_LAST_MIN times the median block (the pipelined drain yields each
    chunk once its own block is done, not the next).
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
    per_block = n_layers * steps
    shapes, last = collections.Counter(), {}
    run_attention = tdit.fused_joint_attention

    def recording_attention(q, *a, **k):
        key, mask = (q.shape[0], q.shape[1], a[2].shape[1]), a[4]

        def record():
            shapes[key] += 1
            if sum(shapes.values()) % per_block == 0:
                # a block's last call: under a replay the mask is the
                # graph's own buffer, which holds this replay's values
                # until the next program runs.  One clone a block: a clone
                # a call would queue 960 launches behind each replayed
                # block, fill the card's launch queue and hold the host in
                # the next replay until the block is done, which the drain
                # gate below would read as a chunk held back
                last["mask"] = mask.clone()
        note(record)
        return run_attention(q, *a, **k)

    name = "r: examples.soak_long_stream, 16 x 320 latents"
    import torch
    from echo_tts_torch.sampler import blockwise as bw
    from echo_tts_torch.utils import programs
    later0 = bw.BLOCK_PROGRAMS.misses
    log(f"  request r: before it, memory_allocated "
        f"{torch.cuda.memory_allocated()}, memory_reserved "
        f"{torch.cuda.memory_reserved()}, the programs' pool "
        f"{programs.pool_bytes(models.device)} bytes, programs "
        f"{programs.stats()}")
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
    n_calls = n_blocks + soak.WARM_BLOCKS
    want = _want(attn=per_block * n_calls, res_stream=3 * n_calls)
    want_measured = {"joint_attention": per_block * n_blocks, "res_stack": 0,
                     "res_stack_stream": 3 * n_blocks}
    # the warm pass at the measured stream's bucket captured its one
    # later-block program, which every later block replays
    later = bw.BLOCK_PROGRAMS.misses - later0
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
            or valid != SOAK_LAST_VALID or text_valid != SOAK_TEXT_VALID
            or later != 1):
        raise AssertionError(
            f"{name}: exit {rc}, failures {report['failures']}; later-block "
            f"programs captured {later}, want 1; launches "
            f"{got}, want {want}; measured {report['launches']}, want "
            f"{want_measured}; kernel A (GB, S, T) {dict(shapes)}; the last "
            f"block's valid latent columns {valid}, text columns "
            f"{text_valid}")
    blocks = report["blocks"]
    # the pipelined drain yields each chunk once its own block is done: a
    # chunk held back until the next block is done shows as a first later
    # block of about two blocks and a last one of about none
    ms = [b["block_ms"] for b in blocks]
    median = float(np.median(ms))
    if not (ms[1] < SOAK_FIRST_LATER_MAX * median
            and ms[-1] > SOAK_LAST_MIN * median):
        raise AssertionError(
            f"{name}: block ms {[round(v, 1) for v in ms]}: the first later "
            f"block {ms[1]:.1f} (bound {SOAK_FIRST_LATER_MAX} x the median "
            f"{median:.1f}), the last {ms[-1]:.1f} (bound above "
            f"{SOAK_LAST_MIN} x the median): a chunk waited for the next "
            f"block")
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
        f"{SOAK_LATENT_COLUMNS}, text columns {text_valid} of 768; one "
        f"later-block program for the 15 later blocks; the first later "
        f"block {ms[1] / median:.3f} and the last {ms[-1] / median:.3f} of "
        f"the median block {median:.1f} ms (bounds {SOAK_FIRST_LATER_MAX}, "
        f"{SOAK_LAST_MIN}) ({card})")
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
# phase 3, continued: the measurement modules (echo_tts_torch/examples/
# bench_*.py), requests (t)-(w)
# ---------------------------------------------------------------------------

# The JAX script's forward count at B = 1 (examples/bench_train_step.py
# _useful_fwd_tflop(base_dit_config(), 1)); request (v) holds the port's to it
TRAIN_FWD_TFLOP_B1 = 2.51984871424
TRAIN_SWEEP_MAX_B = 16
# (w) streams bench_incremental_crossover at this total (5 blocks; 1280,
# 7 blocks, until the programs' captures lengthened the script)
CROSSOVER_TOTAL = 640
# one timed call of each stage and no warm-up: the requests before them
# have run every kernel and code path these reach
BENCH_REPS = ["--warmup", "0", "--reps", "1"]
# (t), (u) and (w)'s sampler-bound modules (bench_kv_quant,
# bench_int8_surfaces, bench_long_reference, bench_stream_int8,
# bench_incremental_crossover) run CHECK_STEPS Euler steps a sampler call,
# not 40: depth cut to keep the script inside its time, since each of
# their calls runs once, eagerly, and is captured.  The steps change no
# kernel shape (CFG and plain steps both run); the 40-step paths are
# requests (a)-(h), (p)-(s), (y) and (z)
CHECK_STEPS = 8
BENCH_STEPS = ["--steps", str(CHECK_STEPS)]


def run_bench(module, argv, models) -> dict:
    """module.main(argv, models=models); its one JSON line, parsed (every
    number in it finite); raises on a non-zero exit."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv, models=models)
    out = buf.getvalue().strip().splitlines()
    name = module.__name__.rsplit(".", 1)[-1]
    if rc != 0 or not out:
        raise AssertionError(f"{name} {argv}: exit {rc}, output {out}")
    line = json.loads(out[-1])

    def finite(x):
        if isinstance(x, dict):
            return all(finite(v) for v in x.values())
        if isinstance(x, list):
            return all(finite(v) for v in x)
        return not isinstance(x, float) or math.isfinite(x)

    if not finite(line):
        raise AssertionError(f"{name}: a number is not finite: {out[-1]}")
    log(f"  {name} {' '.join(argv)} ({time.perf_counter() - t0:.1f} s): "
        f"{out[-1]}")
    return line


def _bench_request(module, argv, models, counters, want, name, check=None):
    """Run a bench module; hold its launches to `want` and its line to
    `check` (a list of failures); returns the launches."""
    _reset(counters)
    line = run_bench(module, argv + BENCH_REPS, models)
    got = _read(counters)
    failures = [] if check is None else check(line)
    if got != want or failures:
        raise AssertionError(f"{name}: launches {got}, want {want}; "
                             f"{failures}")
    log(f"  request {name}: launches {got}")
    return got


def request_benches(models, counters, card: str) -> dict:
    """Requests (t)-(w), each bench module's main on phase 3's models with
    one timed call a stage (BENCH_REPS); returns the launch counts."""
    launches = dict.fromkeys(counters, 0)
    for req in (request_kv_quant, request_int8_surfaces, request_train_sweep,
                request_bench_rest):
        for k, v in req(models, counters, card).items():
            launches[k] += v
        stamp(req.__name__)
    return launches


def request_kv_quant(models, counters, card: str) -> dict:
    """(t) bench_kv_quant --long-speaker --w4a8: the sampler at B = 1 and at
    B = 8 over the 6400-latent speaker bucket, each with bf16 and with int8
    static K/V, at CHECK_STEPS steps (kernel A 24 x 8 bf16 and 24 x 8
    int8-K/V launches per sampler call; at B = 8 GB = 24 and 8, T = 768 +
    1600 = 2368), latents finite, the B = 8 K/V sizes those of 24 x 2 x 8
    x 2368 x 2048 values (bf16: 3552 MiB; int8 with fp32 scales over Dh:
    1831.5 MiB), and the M = 120 scan (kernel C 24 x 8 launches for W8A8
    and for W4A8)."""
    from echo_tts_torch.examples import bench_kv_quant
    cfg = models.dit_cfg
    per_call = cfg.num_layers * CHECK_STEPS
    t_long = 768 + bench_kv_quant.LONG_SPEAKER // cfg.speaker_patch_size
    kv_values = 2 * cfg.num_layers * 8 * t_long * cfg.model_size
    want_mb = (kv_values * 2 / 2**20,
               (kv_values + 2 * cfg.num_layers * 8 * t_long * cfg.num_heads * 4)
               / 2**20)

    def check(line):
        rows = line["summary"]
        b8 = rows[1]
        return ([r for r in rows[:2] if not r["latents_finite"]]
                + ([] if (b8["batch"], b8["static_columns"]) == (8, t_long)
                   and (b8["kv_mb_bf16"], b8["kv_mb_int8"]) == want_mb
                   else [f"B = 8 row {b8}, want T {t_long}, MiB {want_mb}"]))

    return _bench_request(
        bench_kv_quant, ["--long-speaker", "--w4a8"] + BENCH_STEPS, models,
        counters,
        _want(attn=2 * per_call, kv8=2 * per_call, int8=2 * per_call),
        "t: bench_kv_quant, B = 8 over the 6400-latent bucket, --w4a8", check)


def request_int8_surfaces(models, counters, card: str) -> dict:
    """(u) bench_int8_surfaces at CHECK_STEPS steps: the W8A8 request at
    seq 224 and one B = 8 run_batch pass (kernel C 8 x 24 x 8 = 1536 a
    sampler call, at M = 3 x 224 and 224, then 24 x 640 and 8 x 640;
    kernel A 192; kernel B 3 a decode: 3, then 2 x 3 for the pass's two
    slices of four)."""
    from echo_tts_torch.examples import bench_int8_surfaces
    per_call = models.dit_cfg.num_layers * CHECK_STEPS
    return _bench_request(
        bench_int8_surfaces, BENCH_STEPS, models, counters,
        _want(attn=2 * per_call, int8=2 * 8 * per_call, res=3 + 2 * 3),
        "u: bench_int8_surfaces, p50 at seq 224 and a B = 8 pass",
        lambda line: [] if line["audio_finite"] else ["audio not finite"])


# (v)'s calls a point: the first runs eagerly and captures the step's
# program (bench_train_step.GRAD_PROGRAMS), the timed one replays it
TRAIN_SWEEP_REPS = ["--warmup", "1", "--reps", "1"]


def request_train_sweep(models, counters, card: str) -> dict:
    """(v) bench_train_step --sweep --remats attn, B = 2 doubling to
    TRAIN_SWEEP_MAX_B or the first out-of-memory point (in the eager run
    or in the capture after it), one warm-up and one timed call a point:
    kernel A 24 launches a step at every B that ran (exact over the
    request when no point ran out of memory), the gradients' sum finite,
    the FLOP count the JAX script's.  An out-of-memory point leaves the
    context working: the sweep goes on to the next policy, and the
    requests after it run."""
    from echo_tts_torch.examples import bench_train_step
    cfg = models.dit_cfg
    name = (f"v: bench_train_step --sweep, remat attn, B = 2 to "
            f"{TRAIN_SWEEP_MAX_B}")
    _reset(counters)
    line = run_bench(bench_train_step, ["--sweep", "--remats", "attn",
                                        "--b-max", str(TRAIN_SWEEP_MAX_B)]
                     + TRAIN_SWEEP_REPS, models)
    got = _read(counters)
    ran = [r for r in line["sweep"] if not r.get("oom")]
    failures = []
    for r in line["sweep"]:
        flop = bench_train_step.useful_fwd_tflop(cfg, r["batch"])
        if abs(flop - r["batch"] * TRAIN_FWD_TFLOP_B1) > 1e-9 * flop:
            failures.append(f"B = {r['batch']}: forward {flop} TFLOP, the JAX "
                            f"script's {r['batch'] * TRAIN_FWD_TFLOP_B1}")
        if not r.get("oom") and (r["launches_per_step"] != cfg.num_layers
                                 or not r["grad_sum_finite"]):
            failures.append(f"B = {r['batch']}: {r}")
    if not ran or (len(ran) == len(line["sweep"])
                   and got != _want(attn=2 * cfg.num_layers * len(ran))):
        failures.append(f"launches {got} for {len(ran)} points of two steps")
    if failures:
        raise AssertionError(f"{name}: {failures}")
    log(f"  request {name}: launches {got}; " + ", ".join(
        f"B = {r['batch']}: " + (
            "out of memory" if r.get("oom") else
            f"{r['step_ms']:.1f} ms, {r['tokens_per_s']:.0f} tokens/s, MFU "
            f"{r['mfu_vs_bf16_peak']:.4f}, peak {r['peak_memory_mb']:.0f} MiB")
        for r in line["sweep"]) + f" ({card})")
    return got


def request_bench_rest(models, counters, card: str) -> dict:
    """(w) bench_long_reference, bench_few_step, bench_stream_int8,
    bench_ttfa_breakdown, bench_incremental_crossover at CROSSOVER_TOTAL,
    bench_attention, bench_int8, each with its launches exact;
    bench_attention's kernel A rows each within REL_RMS_BOUND of the plain
    version on the same inputs."""
    from echo_tts_torch.examples import (
        bench_attention, bench_few_step, bench_incremental_crossover,
        bench_int8, bench_long_reference, bench_stream_int8,
        bench_ttfa_breakdown, stages)
    from echo_tts_torch.serve.presets import growing_schedule
    n_layers = models.dit_cfg.num_layers
    per_call = n_layers * stages.FULL.steps
    per_check = n_layers * CHECK_STEPS          # at BENCH_STEPS
    n_lin = 8                                   # W8A8 linears a block
    few = bench_few_step.FEW_STEPS * n_layers   # no CFG step
    chunks = sum(-(-b // bench_long_reference.CHUNK_LATENTS)
                 for b in bench_long_reference.buckets())
    stream = len(stages.STREAM_BLOCKS) * per_check
    crossover = len(growing_schedule(CROSSOVER_TOTAL))
    scans = bench_int8.FULL["layers"] * bench_int8.FULL["repeat"] * (3 + 5)
    launches = dict.fromkeys(counters, 0)

    def attention_rows(line):
        # kernel A against its plain version at the sweep's shapes (up to S
        # = 2048, T = 2432, GB = 24), which no phase-4 case holds
        return [r for r in line["rows"]
                if not r["rel_rms_vs_plain"] <= REL_RMS_BOUND]

    for module, argv, want, check in (
            (bench_long_reference, BENCH_STEPS,
             _want(attn=3 * per_check, res=3 * chunks), None),
            (bench_few_step, [], _want(attn=2 * few + per_call,
                                       int8=n_lin * few, res=3), None),
            (bench_stream_int8, BENCH_STEPS,
             _want(attn=2 * stream, int8=n_lin * stream,
                   res_stream=2 * 3 * len(stages.STREAM_BLOCKS)), None),
            (bench_ttfa_breakdown, [], _want(attn=3 * per_call,
                                             res_stream=3 * 3), None),
            (bench_incremental_crossover,
             [str(CROSSOVER_TOTAL)] + BENCH_STEPS,
             _want(attn=2 * crossover * per_check), None),
            (bench_attention, [],
             _want(attn=3 * len(bench_attention.SHAPES)), attention_rows),
            (bench_int8, [], _want(int8=scans), None)):
        got = _bench_request(module, argv, models, counters, want,
                             "w: " + module.__name__.rsplit(".", 1)[-1],
                             check)
        for k, v in got.items():
            launches[k] += v
    return launches


# ---------------------------------------------------------------------------
# phase 3, continued: the weight-validation gate, request (x)
# ---------------------------------------------------------------------------

def _write_model_dir(models, path: str) -> None:
    """`models` as the published files (their state dicts under the
    checkpoints' keys, the PCA state under the reference's names)."""
    import torch
    from safetensors.torch import save_file
    from echo_tts_torch.pipeline import pipeline as pl

    def host(module):
        return {k: v.detach().cpu().contiguous()
                for k, v in module.state_dict().items()}

    save_file(host(models.dit), os.path.join(path, pl.DIT_WEIGHTS))
    save_file(host(models.dac), os.path.join(path, pl.DAC_WEIGHTS))
    pca = models.pca
    save_file({"pca_components": pca["components"].float().cpu().contiguous(),
               "pca_mean": pca["mean"].float().cpu().contiguous(),
               "latent_scale": torch.tensor(pca["latent_scale"],
                                            dtype=torch.float32)},
              os.path.join(path, pl.PCA_WEIGHTS))


def request_validate(models, counters, n_layers: int,
                     n_int8_linears: int) -> dict:
    """Request (x): tools/validate_weights.main on phase 3's full-width
    random models written as a directory of the published files (DiT,
    codec, PCA; deleted afterwards), with --no-reference --int8-report at
    its defaults (8 steps, sequence 160, 64 speaker latents, the six
    presets).  Gates: exit 0, every leg that ran passed (each preset's fp32
    and bf16 latents and the codec's fp32 and serving round trips finite
    and not silent), every number in the report finite, and the launches
    exact: kernel A 2 x 6 x 8 x 24 = 2304 (each preset's bf16 sampler and
    its W8A8 sampler; the fp32 legs run the plain versions), kernel C 6 x
    8 x 24 x 8 = 9216 (the W8A8 sampler's eight linears a layer), kernel B
    6 (the bf16 round trip of 32 latents: three encoder stacks at L =
    65536, 32768 and 8192, three decoder stacks; the fourth stack of each
    runs at C = 512 and 768, past the kernel's widths).  The kernels'
    shapes are recorded and must be VALIDATE_ATTN (the cond row's text and
    speaker columns VALIDATE_TEXT_VALID of VALIDATE_TEXT and
    VALIDATE_SPEAKER), VALIDATE_MM and VALIDATE_RES, the shapes phase 4
    holds and times.  Returns the launches."""
    import collections
    import contextlib
    import io
    import shutil
    import tempfile
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.models.dac import dac as tdac
    from echo_tts_torch.ops import quant
    from echo_tts_torch.serve.presets import load_presets
    from echo_tts_torch.tools import validate_weights as vw

    n_presets = len(load_presets())
    steps = 8                                   # the tool's --num-steps
    want = _want(attn=2 * n_presets * steps * n_layers,
                 int8=n_int8_linears * n_presets * steps * n_layers, res=6)
    name = "x: tools.validate_weights --no-reference --int8-report"
    shapes = {k: collections.Counter() for k in ("attn", "mm", "res")}
    cond_columns = set()
    saved = (tdit.fused_joint_attention, tdac.fused_res_stack,
             quant.Int8Linear.__dict__["dot"])

    def recording_attention(q, *a, **k):
        key = (q.shape[0], q.shape[1], a[2].shape[1])
        note(lambda: shapes["attn"].update([key]))
        if not capturing():
            cond = a[4][0]
            cond_columns.add((int(cond[:VALIDATE_TEXT].sum()),
                              int(cond[VALIDATE_TEXT:].sum())))
        return saved[0](q, *a, **k)

    def recording_res_stack(x, weights, **k):
        key = (x.shape[2], x.shape[1], k["approx_snake"])
        note(lambda: shapes["res"].update([key]))
        return saved[1](x, weights, **k)

    def recording_dot(x, w8, *a):
        key = (x.numel() // x.shape[-1], x.shape[-1], w8.shape[0])
        note(lambda: shapes["mm"].update([key]))
        return saved[2].__func__(x, w8, *a)

    fresh_programs()
    work = tempfile.mkdtemp(prefix="echo_validate_")
    try:
        t0 = time.perf_counter()
        _write_model_dir(models, work)
        write_s = time.perf_counter() - t0
        out = os.path.join(work, "report.json")
        tdit.fused_joint_attention = recording_attention
        tdac.fused_res_stack = recording_res_stack
        quant.Int8Linear.dot = staticmethod(recording_dot)
        _reset(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = vw.main(["--model-dir", work, "--no-reference",
                          "--int8-report", "--out", out])
        wall = time.perf_counter() - t0
        got = _read(counters)
        with open(out) as f:
            report = json.load(f)
    finally:
        tdit.fused_joint_attention, tdac.fused_res_stack = saved[:2]
        quant.Int8Linear.dot = saved[2]
        shutil.rmtree(work, ignore_errors=True)

    def numbers(x):
        if isinstance(x, dict):
            return [n for v in x.values() for n in numbers(v)]
        if isinstance(x, list):
            return [n for v in x for n in numbers(v)]
        return [x] if isinstance(x, float) else []

    presets, codec = report.get("presets", {}), report.get("codec", {})
    failures = [f"exit {rc}"] if rc != 0 else []
    failures += [f"{k} did not pass" for k, r in presets.items()
                 if not (r["fp32_pass"] and r["bf16_pass"])]
    if len(presets) != n_presets or len(report.get("int8_mode", {})) != n_presets:
        failures.append(f"presets {sorted(presets)}")
    if not (codec.get("roundtrip_pass") and codec.get("serving_pass")):
        failures.append(f"codec: {codec}")
    if (set(shapes["attn"]) != VALIDATE_ATTN
            or cond_columns != {(VALIDATE_TEXT_VALID, VALIDATE_SPEAKER)}
            or set(shapes["mm"]) != VALIDATE_MM
            or set(shapes["res"]) != VALIDATE_RES):
        failures.append(f"kernel shapes: A (GB, S, T) {dict(shapes['attn'])}"
                        f", the cond row's (text, speaker) columns "
                        f"{cond_columns}; C (M, K, N) {dict(shapes['mm'])}; "
                        f"B (C, L, sin2_poly) {dict(shapes['res'])}")
    if report.get("reference_checked") is not False or not report["pass"]:
        failures.append("report: reference_checked or pass")
    if not all(math.isfinite(v) for v in numbers(report)):
        failures.append("a number in the report is not finite")
    if got != want or failures:
        raise AssertionError(f"{name}: {failures}; launches {got}, want "
                             f"{want}")
    log(f"  request {name}: exit {rc}, tool {wall:.1f} s (report "
        f"{report['seconds']} s), files written in {write_s:.1f} s; bf16 "
        f"from fp32 rel-RMS "
        f"{ {k: round(r['bf16_rel_rms_vs_fp32'], 4) for k, r in presets.items()} }; "
        f"round-trip SNR fp32 {codec['roundtrip_snr_db']} dB, serving bf16 "
        f"{codec['serving_roundtrip_snr_db']} dB; int8 rel_err "
        f"{ {k: round(r['rel_err'], 4) for k, r in report['int8_mode'].items()} }; "
        f"launches {got}; kernel A (GB, S, T) {dict(shapes['attn'])}, C "
        f"(M, K, N) {dict(shapes['mm'])}, B (C, L, sin2_poly) "
        f"{dict(shapes['res'])}")
    return got


# ---------------------------------------------------------------------------
# phase 3, continued: the headline bench, request (y)
# ---------------------------------------------------------------------------

# Request (y) runs echo_tts_torch.bench with one warm-up and one timed call
# a stage.  Its one-shot request is 640 latents over 768 text columns (200
# valid) and the 640-latent speaker's 160 patches: static K/V T = 928.  Its
# short request is 224 latents.  Its stream is 1240 latents on
# STREAM_BLOCKS: the blocks after the first read the carried latent prefix,
# padded to the stream's 1280-latent total bucket, 1280 / 4 columns,
# before the text and speaker ones, T = 1248, of which the block's start
# / 4 are valid.
BENCH_Y_ARGS = ["--warmup", "1", "--reps", "1"]
BENCH_T, BENCH_TEXT_VALID = 768 + 640 // 4, 200
BENCH_LAT = 1280 // 4
BENCH_STREAM_T = BENCH_LAT + BENCH_T
BENCH_STREAM_VALID = {(80, 10), (160, 30), (320, 70), (320, 150), (320, 230)}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "prefill_ms",
              "sampler_ms", "decode_ms", "p50_short_ms", "ttfa_ms",
              "ttfa_serve_ms", "streamed_rtf", "throughput_rtf_b8",
              "throughput_rtf_b8_chip", "sampler_int8_ms", "rtf_int8"}


def bench_decode_shapes(latents: int, batch: int = 1, history: bool = False,
                        encode: bool = False) -> set:
    """Kernel B's (C, L, sin2_poly, batch, history form) for a decode (or,
    with `encode`, an encode) of `latents` latents: the decoder's blocks
    at C = 384, 192, 96 (2048 / 8, 2048 / 2 and 2048 samples a latent,
    sin2_poly), the encoder's at C = 64, 128, 256 (exact sin)."""
    widths = (((64, 2048), (128, 1024), (256, 256)) if encode
              else ((384, 256), (192, 1024), (96, 2048)))
    return {(c, latents * per, not encode, batch, history)
            for c, per in widths}


def bench_expected(n_layers: int, steps: int, calls: int) -> dict:
    """Per stage of echo_tts_torch.bench, each run `calls` times (warm-up
    and timed): (launches, kernel A's (GB, S, T), kernel B's shapes,
    kernel C's (M, K, N)).  A sampler call launches kernel A n_layers x
    steps times (GB = 3 on the CFG steps, 1 on the rest), a stream that
    many a block; a decode runs three kernel-B stacks (the decoder's
    fourth, C = 768, is past the kernel's widths), a streamed block three
    in the history form, a decode of the B = 8 pass two slices of four;
    the W8A8 sampler launches kernel C for its eight linears a layer; the
    served stream's first call encodes the 640-latent voice (three
    encoder stacks) and the later ones hit the voice cache."""
    from echo_tts_torch.examples.stages import STREAM_BLOCKS
    per = n_layers * steps
    one = {(3, 640, BENCH_T), (1, 640, BENCH_T)}
    streamed = ({(g, 40, BENCH_T) for g in (3, 1)}
                | {(g, s, BENCH_STREAM_T) for g in (3, 1) for s in (80, 160, 320)})
    hist = set().union(*(bench_decode_shapes(b, history=True)
                         for b in set(STREAM_BLOCKS)))
    b8 = {(24, 640, BENCH_T), (8, 640, BENCH_T)}
    mm = {(gb * 640, k, n) for gb in (3, 1) for k, n in DIT_INT8_KN}
    blocks = len(STREAM_BLOCKS)
    return {
        "one_shot": (_want(attn=per * calls, res=3 * calls), one,
                     bench_decode_shapes(640), set()),
        "prefill": (_want(), set(), set(), set()),
        "sampler": (_want(attn=per * calls), one, set(), set()),
        "decode": (_want(res=3 * calls), set(), bench_decode_shapes(640),
                   set()),
        "p50_short": (_want(attn=per * calls, res=3 * calls),
                      {(3, 224, BENCH_T), (1, 224, BENCH_T)},
                      bench_decode_shapes(224), set()),
        "sampler_int8": (_want(attn=per * calls, int8=8 * per * calls), one,
                         set(), mm),
        "stream": (_want(attn=blocks * per * calls,
                         res_stream=3 * blocks * calls), streamed, hist, set()),
        "serve": (_want(attn=blocks * per * calls, res=3,
                        res_stream=3 * blocks * calls), streamed,
                  hist | bench_decode_shapes(640, encode=True), set()),
        "batch": (_want(attn=per * calls, res=6 * calls), b8,
                  bench_decode_shapes(640, batch=4), set()),
        "b8_chip": (_want(attn=per * calls, res=6 * calls), b8,
                    bench_decode_shapes(640, batch=4), set()),
    }


def bench_res_shapes() -> dict:
    """Kernel B's shapes in request (y), by phase 4's case name."""
    shapes = set().union(*(e[2] for e in bench_expected(1, 1, 1).values()))
    return {res_shape(c, length, approx) + (" history" if hist else "")
            + (f" batch {batch}" if batch > 1 else ""):
            (c, length, approx, batch, hist)
            for c, length, approx, batch, hist in shapes}


def stream_text_valid() -> int:
    """The text columns STREAM_TEXT fills (bytes and markers)."""
    from echo_tts_torch.examples.stages import STREAM_TEXT
    from echo_tts_torch.pipeline.text import get_text_input_ids_and_mask
    return int(get_text_input_ids_and_mask([STREAM_TEXT], 768)[1].sum())


def request_bench(models, counters, card: str) -> dict:
    """Request (y): echo_tts_torch.bench.main on phase 3's (blockwise)
    models with BENCH_Y_ARGS.  Gates: exit 0; its line holds bench.py's 15
    keys, card and ranges, every number finite and above 0; each stage's
    launches of kernels A (bf16 and int8 K/V), B (one-shot and history
    form) and C exactly bench_expected's (with 24 layers and 40 steps,
    two calls a stage: A 1920 for the one-shot request, the sampler, the
    short request, the W8A8 sampler, the B = 8 pass and its device stages,
    11 520 for the stream and the served stream; B 6 for the one-shot
    request, the decode and the short request, 12 for each B = 8 form, 3
    one-shot (the voice's encode) and 36 history-form for the served
    stream, 36 history-form for the stream; C 15 360 for the W8A8
    sampler); kernel A's (GB, S, T), B's and C's shapes by stage exactly
    bench_expected's, the shapes phase 4 holds (BENCH_*); the streamed
    blocks' valid latent columns BENCH_STREAM_VALID, and the cond row's
    text columns 200 on the one-shot stages, STREAM_TEXT's on the streams.
    The stream stage's timed call replays bit for bit the programs its
    warm-up ran eagerly and captured (its inputs and audio are kept in
    BENCH_STREAM for request (z)).  Prints the bench's line on a line of
    its own; returns the launches."""
    import collections
    from echo_tts_torch import SAMPLER_DEFAULTS, bench
    from echo_tts_torch.examples import stages
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.models.dac import dac as tdac
    from echo_tts_torch.ops import quant

    calls = 2                                   # one warm-up, one timed
    expected = bench_expected(models.dit_cfg.num_layers,
                              SAMPLER_DEFAULTS["num_steps"], calls)
    name = "y: echo_tts_torch.bench, one warm-up and one timed call a stage"
    current = [None]
    per_stage = {}
    shapes = collections.defaultdict(lambda: {k: collections.Counter()
                                              for k in ("attn", "res", "mm")})
    # stage -> [(T, S, mask)], the mask of the last attention call of each
    # sampler call or streamed block (a program's run), eager or replayed
    masks = collections.defaultdict(list)
    attn_calls = collections.Counter()
    per_run = models.dit_cfg.num_layers * SAMPLER_DEFAULTS["num_steps"]
    saved = (bench.stage, tdit.fused_joint_attention, tdac.fused_res_stack,
             quant.Int8Linear.__dict__["dot"])

    def counting_stage(stage_name, fn, *a):
        current[0] = stage_name
        # a stage's first call runs eagerly and captures its programs
        # (request (x) dropped every program), its second replays them;
        # the recorders below read both
        _reset(counters)
        try:
            return saved[0](stage_name, fn, *a)
        finally:
            per_stage[stage_name] = _read(counters)
            current[0] = None

    def recording_attention(q, *a, **k):
        t = a[2].shape[1]
        key, mask = (q.shape[0], q.shape[1], t), a[4]

        def record():
            stage = current[0]
            shapes[stage]["attn"].update([key])
            attn_calls[stage] += 1
            if attn_calls[stage] % per_run == 0:
                # under a replay the mask is the graph's own buffer, which
                # holds this replay's values until the next program runs
                masks[stage].append((t, key[1], mask.clone()))
        note(record)
        return saved[1](q, *a, **k)

    def recording_res_stack(x, weights, **k):
        key = (x.shape[2], x.shape[1], k["approx_snake"], x.shape[0],
               k.get("history") is not None)
        note(lambda: shapes[current[0]]["res"].update([key]))
        return saved[2](x, weights, **k)

    def recording_dot(x, w8, *a):
        key = (x.numel() // x.shape[-1], x.shape[-1], w8.shape[0])
        note(lambda: shapes[current[0]]["mm"].update([key]))
        return saved[3].__func__(x, w8, *a)

    # the stream stage's calls: its warm-up runs the stream's programs
    # eagerly and captures them (request (x) dropped every program), its
    # timed call replays them
    stream_once = stages.stream_once
    streams = []

    def recording_stream_once(m, spk, blocks, kw, mask=None, audio=None):
        chunks = [] if audio is None else audio
        misses = stream_misses()
        out = stream_once(m, spk, blocks, kw, mask, audio=chunks)
        streams.append(dict(misses=stream_misses() - misses,
                            chunks=[np.array(c) for c in chunks],
                            audio=np.concatenate(chunks, axis=-1),
                            inputs=(m, spk, list(blocks), dict(kw), mask)))
        return out

    bench.stage = counting_stage
    tdit.fused_joint_attention = recording_attention
    tdac.fused_res_stack = recording_res_stack
    quant.Int8Linear.dot = staticmethod(recording_dot)
    stages.stream_once = recording_stream_once
    try:
        line = run_bench(bench, BENCH_Y_ARGS, models)
    finally:
        bench.stage, tdit.fused_joint_attention, tdac.fused_res_stack = saved[:3]
        quant.Int8Linear.dot = saved[3]
        stages.stream_once = stream_once
    launches = dict.fromkeys(counters, 0)
    for got in per_stage.values():
        for k, v in got.items():
            launches[k] += v

    failures = []
    numbers = [v for k, v in line.items() if k in BENCH_KEYS
               and not isinstance(v, str)]
    if (set(line) != BENCH_KEYS | {"card", "ranges"} or len(numbers) != 13
            or not all(math.isfinite(v) and v > 0 for v in numbers)):
        failures.append(f"keys {sorted(line)} or a number not above 0")
    for stage_name, (want, attn, res, mm) in expected.items():
        got = per_stage.get(stage_name)
        s = shapes[stage_name]
        if (got != want or set(s["attn"]) != attn or set(s["res"]) != res
                or set(s["mm"]) != mm):
            failures.append(
                f"{stage_name}: launches {got}, want {want}; A (GB, S, T) "
                f"{dict(s['attn'])}, want {sorted(attn)}; B {dict(s['res'])}, "
                f"want {sorted(res)}; C {dict(s['mm'])}, want {sorted(mm)}")
    if set(per_stage) != set(expected):
        failures.append(f"stages {sorted(per_stage)}")
    # the cond row's valid columns: text on every stage but the batch's
    # (one text a request), the latent prefix on the streamed blocks
    text_stream = stream_text_valid()
    for stage_name, seen in masks.items():
        want_text = (text_stream if stage_name in ("stream", "serve")
                     else BENCH_TEXT_VALID)
        for t, s, mask in seen:
            lat = BENCH_LAT if t == BENCH_STREAM_T else 0
            text = int(mask[0, lat:lat + 768].sum())
            if stage_name != "batch" and text != want_text:
                failures.append(f"{stage_name}: T = {t}, {text} text columns "
                                f"valid, want {want_text}")
    for stage_name in ("stream", "serve"):
        valid = {(s, int(m[0, :BENCH_LAT].sum()))
                 for t, s, m in masks[stage_name] if t == BENCH_STREAM_T}
        if valid != BENCH_STREAM_VALID:
            failures.append(f"{stage_name}: the streamed blocks' (S, valid "
                            f"latent columns) {sorted(valid)}")
    # the 1240-latent stream at 40 steps: the timed call's replay bit for
    # bit the warm-up's eager run; request (z) replays a second input set
    replayed = (len(streams) == calls and streams[0]["misses"] > 0
                and all(r["misses"] == 0 for r in streams[1:])
                and all(np.array_equal(r["audio"], streams[0]["audio"])
                        for r in streams[1:]))
    if not replayed:
        failures.append(
            f"stream: programs captured per call "
            f"{[r['misses'] for r in streams]}, replay bit for bit the eager "
            f"run: {replayed}; each block's max-abs from the eager run's "
            + str([[float(np.abs(a - b).max()) for a, b in
                    zip(r["chunks"], streams[0]["chunks"])]
                   for r in streams[1:]]))
    if failures:
        raise AssertionError(f"{name}: {failures}")
    BENCH_STREAM.update(inputs=streams[0]["inputs"], audio=streams[0]["audio"])
    log(json.dumps(line))
    log(f"  request y: the stream's warm-up ran eagerly and captured "
        f"{streams[0]['misses']} programs; the timed call replayed them, "
        f"bit for bit the eager run: {replayed}")
    log(f"  request {name}: launches by stage {per_stage}; stage sum "
        f"(prefill + sampler + decode) over the one-shot wall "
        f"{(line['prefill_ms'] + line['sampler_ms'] + line['decode_ms']) / (1e3 * 640 * models.dac_cfg.frame_length / models.dac_cfg.sample_rate / line['value']):.4f} "
        f"({card})")
    return launches


# ---------------------------------------------------------------------------
# phase 3, continued: the compiled-program layer, request (z)
# ---------------------------------------------------------------------------

# request (z)'s second input set: request (b)'s shapes (the text padded to
# 768 bytes, the voice's latents), another text and seed
Z_TEXT = "A second request at the same key reads another sentence aloud."
Z_SEED = 101
# request (y)'s 1240-latent stream: its inputs (models, speaker latents,
# block sizes, sampler parameters, speaker mask) and its eager run's audio
BENCH_STREAM = {}
# (W8A8 DiT, int8 static K/V): bf16; kv_quant; request (d)'s int8 modes
Z_MODES = {"bf16": (False, False), "kv8": (False, True),
           "w8a8_kv8": (True, True)}


def manifest_launches(manifest, n_layers: int, steps: int) -> dict:
    """Kernel launches of one warmup_compile pass over `manifest`: the
    640-latent voice encode (3 stacks), then per entry a sampler call (n
    layers x steps, a stream's per block) and its decodes (3 stacks a
    decode of up to 4 rows, 3 history-form stacks a streamed block)."""
    attn, res, res_stream = 0, 3, 0
    for e in manifest:
        if e["kind"] == "stream":
            attn += len(e["chunk_sizes"]) * n_layers * steps
            res_stream += 3 * len(e["chunk_sizes"])
        else:
            attn += n_layers * steps
            res += 3 * -(-e.get("batch_size", 1) // 4)
    return _want(attn=attn, res=res, res_stream=res_stream)


def stream_replays(models, req_b: dict, qdit, counted, failures: list,
                   card: str) -> None:
    """Request (z)'s streams, at the published 40 steps a block:

      * request (y)'s 1240-latent stream (BENCH_STREAM), whose replay
        request (y) held bit for bit against its eager run: a second input
        set (Z_TEXT at Z_SEED) replays the programs request (y) captured
        (no capture), then bit for bit its own eager run after every
        program is dropped;
      * request (g)'s W8A8 stream ([40, 80], the voice's latents): after
        every program is dropped, the first input set's eager run captures
        its programs, the same stream again replays them bit for bit, the
        second input set replays them bit for bit its own eager run (after
        the programs are dropped again).

    A second input set catches a position or value baked into a graph.
    Every run's launches exact (kernel A 24 x 40 a block, kernel C 8 per
    attention under W8A8, kernel B's history form 3 a block); a first run
    captures one later-block program per distinct later block size
    (request (y)'s three 320-latent blocks one), a replay none.  Request
    (e)'s stream is request (q)'s: its WAV replays (e)'s programs bit for
    bit (e)'s eager chunks."""
    import dataclasses
    from echo_tts_torch import SAMPLER_DEFAULTS, stream_synthesize
    from echo_tts_torch.sampler import blockwise as bw
    from echo_tts_torch.utils import programs

    per_block = models.dit_cfg.num_layers * SAMPLER_DEFAULTS["num_steps"]
    dev = models.device
    voice = (req_b["spk"].cpu().numpy(), req_b["smask"].cpu().numpy())
    streams = {}
    if BENCH_STREAM:
        m_y, spk_y, blocks_y, kw_y, mask_y = BENCH_STREAM["inputs"]
        streams["y"] = (m_y, blocks_y, kw_y, None,
                        (Z_TEXT, Z_SEED, spk_y, mask_y))
    else:
        log("  request z: request (y) did not run; its stream is not checked")
    streams["g_w8a8"] = (dataclasses.replace(models, dit=qdit), [40, 80], {},
                         (TEXT, 5) + voice, (Z_TEXT, Z_SEED) + voice)
    for name, (m, schedule, kw, first, second) in streams.items():
        w8a8 = m.dit is qdit
        want = _want(attn=per_block * len(schedule),
                     int8=8 * per_block * len(schedule) if w8a8 else 0,
                     res_stream=3 * len(schedule))

        def run(inputs, what):
            text, seed, lat, mask = inputs
            return counted(lambda: np.concatenate(
                [c.audio for c in stream_synthesize(
                    m, text, chunk_sizes=schedule, seed=seed,
                    speaker_latent=lat, speaker_mask=mask,
                    sampler_params=kw)], axis=-1), want,
                f"stream {name} {what}")

        same, captures, eager_s, later = {}, [], None, None
        if first is None:
            # request (y)'s programs, captured by its warm-up
            eager_a = BENCH_STREAM["audio"]
        else:
            fresh_programs()
            n0, later0 = len(programs.CAPTURES), bw.BLOCK_PROGRAMS.misses
            t0 = time.perf_counter()
            eager_a = run(first, "eager")
            eager_s = time.perf_counter() - t0
            captures = programs.CAPTURES[n0:]
            later = bw.BLOCK_PROGRAMS.misses - later0
            same["replay"] = np.array_equal(run(first, "replay"), eager_a)
        n1 = len(programs.CAPTURES)
        t0 = time.perf_counter()
        replay_b = run(second, "replay, 2nd set")
        replay_s = time.perf_counter() - t0
        recaptured = len(programs.CAPTURES) - n1
        static, pool = programs.static_bytes(dev), programs.pool_bytes(dev)
        fresh_programs()
        later0 = bw.BLOCK_PROGRAMS.misses
        eager_b = run(second, "eager, 2nd set")
        if later is None:
            later = bw.BLOCK_PROGRAMS.misses - later0
        same.update(second_set=np.array_equal(replay_b, eager_b),
                    sets_differ=not np.array_equal(eager_a, replay_b))
        if (not all(same.values()) or recaptured
                or later != len(set(schedule[1:]))):
            failures.append(f"stream {name}: bit-equal {same}; captures on "
                            f"replay {recaptured}; later-block programs "
                            f"{later}, want {len(set(schedule[1:]))}")
        log(f"  request z, stream {name} {schedule}, 40 steps: replay "
            f"against the eager run, bit for bit: {same}"
            + ("" if eager_s is None else
               f"; first run {eager_s:.2f} s (eager and {len(captures)} "
               f"captures, {sum(sec for _, sec in captures):.2f} s of "
               f"capture: {[(n, round(sec, 3)) for n, sec in captures]})")
            + f"; replay of the 2nd set {replay_s:.2f} s; later-block "
            f"programs {later}; static inputs {static} bytes, pool {pool} "
            f"bytes ({card})")


def request_programs(models, req_b: dict, counters, card: str) -> dict:
    """Request (z): the compiled-program layer (utils/programs.py).  After
    dropping every program:

      * request (b)'s inputs in each of Z_MODES (bf16; int8 static K/V;
        the W8A8 DiT with int8 static K/V, kernel C inside) through
        pipeline.euler_sample_fn: the first call runs eagerly and captures
        its program, the second replays it, bit for bit the first (and, in
        bf16, request (b)'s latents); Z_TEXT at Z_SEED (the same shapes,
        so the same program) replayed is bit for bit its own eager run
        (after the programs are dropped again), which catches a request's
        value baked into a graph; each call's launches exact (kernel A 960
        bf16 or int8-K/V, kernel C 7680 under W8A8); in bf16 the decode's
        replay bit for bit its eager run (kernel B 3 a call);
      * first, while request (y)'s programs live, the streams of
        stream_replays at 40 steps: requests (y) and (g) (W8A8), each
        replayed bit for bit its eager run, and a second input set bit for
        bit its own;
      * serve.handler.warmup_compile over the default manifest with
        batch_sizes=(8,) at full width: each entry's seconds and its
        programs' capture seconds, the shared pool's bytes and
        torch.cuda.memory_reserved() after it (the caching allocator's
        free blocks returned first); its launches exact
        (manifest_launches: eager first calls and replays, the captures
        launching nothing);
      * a second pass over the manifest: no capture (every cache's misses
        unchanged), memory_reserved not above the first pass's, the same
        launches, all of the sampler's and the codec's from replays.

    Then drops every program, so that training starts with the pool
    freed.  Returns the launch counts."""
    import dataclasses
    import gc

    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.ops.quant import quantize_dit
    from echo_tts_torch.pipeline import pipeline as pl
    from echo_tts_torch.pipeline.text import get_text_input_ids_and_mask
    from echo_tts_torch.serve import handler as th
    from echo_tts_torch.serve.presets import warmup_manifest
    from echo_tts_torch.utils import programs

    name = "z: the compiled-program layer"
    n_layers, steps = models.dit_cfg.num_layers, SAMPLER_DEFAULTS["num_steps"]
    per_call = n_layers * steps
    dev = models.device
    total = dict.fromkeys(counters, 0)
    failures = []

    def counted(fn, want, what):
        _reset(counters)
        out = fn()
        torch.cuda.synchronize()
        got = _read(counters)
        for k, v in got.items():
            total[k] += v
        if got != want:
            failures.append(f"{what}: launches {got}, want {want}")
        return out

    x = (req_b["spk"], req_b["smask"], req_b["ids"], req_b["tmask"],
         req_b["seed"])
    ids, tmask = get_text_input_ids_and_mask([Z_TEXT], 768)
    y = (req_b["spk"], req_b["smask"], torch.from_numpy(ids).to(dev),
         torch.from_numpy(tmask).to(dev), Z_SEED)
    qdit = quantize_dit(models.dit)
    stream_replays(models, req_b, qdit, counted, failures, card)
    BENCH_STREAM.clear()
    stamp("request z, streams")
    for mode, (w8a8, kv8) in Z_MODES.items():
        m = dataclasses.replace(models, dit=qdit) if w8a8 else models
        fn = functools.partial(pl.euler_sample_fn, kv_quant=kv8,
                               **SAMPLER_DEFAULTS)
        want = _want(attn=0 if kv8 else per_call, kv8=per_call if kv8 else 0,
                     int8=8 * per_call if w8a8 else 0)
        fresh_programs()
        misses = programs.stats()["euler"]["misses"]
        eager_x = counted(lambda: fn(m, *x), want, f"{mode} eager")
        replay_x = counted(lambda: fn(m, *x), want, f"{mode} replay")
        replay_y = counted(lambda: fn(m, *y), want, f"{mode} replay, 2nd set")
        if programs.stats()["euler"]["misses"] != misses + 1:
            failures.append(f"{mode}: {programs.stats()['euler']} after one "
                            "key's three calls")
        fresh_programs()
        eager_y = counted(lambda: fn(m, *y), want, f"{mode} eager, 2nd set")
        same = dict(replay=torch.equal(replay_x, eager_x),
                    second_set=torch.equal(replay_y, eager_y),
                    sets_differ=not torch.equal(replay_x, replay_y))
        if mode == "bf16":
            same["request_b"] = torch.equal(eager_x, req_b["latents"])
            fresh_programs()
            decode_want = _want(res=3)
            eager_a = counted(lambda: pl.ae_decode(models, eager_x),
                              decode_want, "decode eager")
            replay_a = counted(lambda: pl.ae_decode(models, eager_x),
                               decode_want, "decode replay")
            same["decode_replay"] = torch.equal(replay_a, eager_a)
        if not all(same.values()):
            failures.append(f"{mode}: bit-equal {same}")
        log(f"  request z, {mode}: replay against the eager run, bit for "
            f"bit: {same}")
    del qdit
    stamp("request z, sampler modes")

    manifest = warmup_manifest((8,))
    want = manifest_launches(manifest, n_layers, steps)
    fresh_programs()
    gc.collect()
    reserved0 = torch.cuda.memory_reserved(dev)
    passes = []
    for i in range(2):
        captures = len(programs.CAPTURES)
        rss0, n_rss = host_rss(), len(CAPTURE_RSS)
        t0 = time.perf_counter()
        report = counted(lambda: th.warmup_compile(models, batch_sizes=(8,)),
                         want, f"warm-up pass {i + 1}")
        seconds = time.perf_counter() - t0
        # the host memory each capture kept, and the pass's growth
        grown = [(n, after - before) for n, before, after in
                 CAPTURE_RSS[n_rss:]]
        log(f"  request z, warm-up pass {i + 1}: host RSS {rss0} bytes "
            f"before, {host_rss()} after; over each capture (cache, bytes) "
            f"{grown}, {sum(d for _, d in grown)} bytes in all ({card})")
        # what the caching allocator keeps: the programs' pool, the models,
        # the caches; garbage and free blocks returned first
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        passes.append(dict(seconds=seconds, stats=programs.stats(),
                           reserved=torch.cuda.memory_reserved(dev),
                           pool=programs.pool_bytes(dev),
                           static=programs.static_bytes(dev),
                           captured=len(programs.CAPTURES) - captures,
                           capture_s=sum(s for r in report
                                         for s in r["captures"])))
        for r in report:
            e = r["entry"]
            log(f"  request z, warm-up pass {i + 1}: {e['kind']} "
                f"{ {k: v for k, v in e.items() if k != 'kind'} }: "
                f"{r['seconds']:.2f} s, capture seconds {r['captures']}, "
                f"pool {r['pool_bytes']} bytes, static inputs "
                f"{r['static_bytes']} bytes")
    first, second = passes
    if (second["captured"] or first["captured"] == 0
            or any(second["stats"][c]["misses"] != first["stats"][c]["misses"]
                   for c in first["stats"])
            or second["reserved"] > first["reserved"]):
        failures.append(f"second pass: {second}, first {first}")
    log(f"  request z: default manifest with batch_sizes=(8,), "
        f"{len(manifest)} entries: pass 1 {first['seconds']:.1f} s "
        f"({first['captured']} programs captured, {first['capture_s']:.2f} s "
        f"of capture), pass 2 {second['seconds']:.1f} s (captured "
        f"{second['captured']}); programs {second['stats']}; pool "
        f"{first['pool']} bytes, static inputs {first['static']} bytes; "
        f"memory_reserved {reserved0} before, "
        f"{first['reserved']} after pass 1, {second['reserved']} after pass 2 "
        f"({card})")
    fresh_programs()
    if failures:
        raise AssertionError(f"{name}: {failures}")
    log(f"  request {name}: launches {total}")
    return total


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


# Request (i)'s EMA decay: the train programs update the EMA in place too
TRAIN_EMA = 0.999


class StepTimes:
    """Wraps a module's step-function factory (make_train_step,
    make_distill_step) so that each step it makes is timed on the host
    clock between synchronises and its kernel A launches are counted:
    `ms` and `launches` get one entry a step.  With eager=True each step
    runs its body without the program (the step's `eager`)."""

    def __init__(self, module, name: str, eager: bool = False):
        self.module, self.name, self.eager = module, name, eager
        self.make = getattr(module, name)
        self.ms, self.launches = [], []

    def __enter__(self):
        import torch
        from echo_tts_torch.ops.joint_attention import fused_joint_attention

        def make(*a, **k):
            step = self.make(*a, **k)
            run = step.eager if self.eager else step

            def timed_step(*sa, **sk):
                torch.cuda.synchronize()
                n0 = fused_joint_attention.launches
                t0 = time.perf_counter()
                out = run(*sa, **sk)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.launches.append(fused_joint_attention.launches - n0)
                return out
            return timed_step

        setattr(self.module, self.name, make)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.make)
        return False


@contextlib.contextmanager
def no_sync_in_eager_runs():
    """Every program's eager miss run, not its capture, under
    torch.cuda.set_sync_debug_mode("error"): a host sync inside a step's
    body raises there."""
    import torch
    from echo_tts_torch.utils import programs
    call = programs.Program._call_body

    def strict(self, owner):
        if capturing():
            return call(self, owner)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return call(self, owner)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    programs.Program._call_body = strict
    try:
        yield
    finally:
        programs.Program._call_body = call


def captures_since(n_captures: int, n_rss: int) -> list:
    """[(cache name, capture s, host VmRSS growth bytes)] of the captures
    after the first n_captures (programs.CAPTURES) and n_rss
    (CAPTURE_RSS)."""
    from echo_tts_torch.utils import programs
    return [(name, sec, after - before) for (name, sec), (_, before, after)
            in zip(programs.CAPTURES[n_captures:], CAPTURE_RSS[n_rss:])]


def snapshot(state) -> list:
    """Device copies of a train state's parameters and EMA."""
    mods = [state.model] + ([] if state.ema is None else [state.ema])
    return [p.detach().clone() for m in mods for p in m.parameters()]


def replay_check(name: str, got: tuple, want: tuple) -> None:
    """got, want: (snapshot, losses) of the same steps through the program
    and through the body called eagerly, from the same weights and draws:
    bit for bit equal, or raises with the largest parameter difference.
    The program's first step is an eager run of the body itself, and on an
    H100 its replays have matched the eager body bit for bit in every
    remat mode and in both distill forms: a difference is a fault."""
    import torch
    if got[1] != want[1] or not all(torch.equal(x, y)
                                    for x, y in zip(got[0], want[0])):
        worst = max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(got[0], want[0]))
        raise AssertionError(f"{name}: the program's steps differ from the "
                             f"body's: losses {got[1]} / {want[1]}, "
                             f"parameters max-abs {worst:.3e}")


def _free():
    """Collect garbage, drop the programs of freed owners (their graphs'
    pool memory with them), return the cache to the card."""
    import gc

    import torch
    from echo_tts_torch.utils import programs
    gc.collect()
    programs.purge()
    torch.cuda.empty_cache()


def request_train(counters, card: str) -> dict:
    """Request (i): `train` on the published 24-layer DiT (blockwise=False,
    as the JAX package trains it; seeded random bf16 weights) at B = 2 on
    one batch of the DataConfig shapes, t and eps fixed across steps, an
    EMA at TRAIN_EMA: three steps in each remat mode, each from the same
    initial weights, through the train step's program (train/step.py
    TRAIN_PROGRAMS): step 1 its eager run, under
    torch.cuda.set_sync_debug_mode("error") (no host sync in the body),
    and its capture (seconds, host VmRSS growth, the pool's bytes after),
    steps 2 and 3 replays.  Per mode: one step's gradients
    (flow_matching_loss backward, as the first update sees them) against
    "none"'s (rel-RMS 1e-2), kernel A's launches in each step (exact: L
    under "none", "attn", "dots_all"; 2 L under "full" and "dots", whose
    recompute re-runs the forward), the step ms (host clock between
    synchronises; steps 2-3 replayed), the peak memory
    (torch.cuda.max_memory_allocated, reset before the run, and what was
    resident then); the loss finite and lower at step 3 than at step 1,
    and the first-step losses of all modes within relative 1e-3.  The
    replay check: the same three steps with the step's body called
    eagerly, from the same weights and draws, their losses, parameters
    and EMA bit for bit the program's (replay_check).  Then the same step
    with joint_attention_plain in place of the kernel, in bf16 and in fp32
    at the bf16 step's timestep: kernel A's step no farther from the fp32
    one than GRAD_FP32_RATIO times the plain bf16 step; AdamW's capturable
    update against the non-capturable one the CPU runs, on "none"'s
    gradients (train_checks.adamw_form_gap, reported); the device clip on
    bf16 gradients bit for bit the host-float clip it replaced; and one
    train step at blockwise=True, whose latent encoder the loss does not
    reach: its gradients stay allocated at zero and AdamW holds state for
    them (the decay optax applies)."""
    import itertools

    import torch
    from echo_tts_torch.config import base_dit_config
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.tools.train_checks import (adamw_form_gap,
                                                   grad_rel_rms,
                                                   precision_gaps,
                                                   step_grads, train_draws)
    from echo_tts_torch.train import loop as tloop
    from echo_tts_torch.train import step as tstep
    from echo_tts_torch.utils import programs

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
    dev = torch.device("cuda")

    def run(mode: str, eager: bool = False) -> tuple:
        """Three train steps in `mode`: (StepTimes, the final state, the
        losses)."""
        losses = []
        with StepTimes(tloop, "make_train_step", eager=eager) as times:
            state = tloop.train(model0, itertools.repeat(batch), num_steps=3,
                                lr=TRAIN_LR, fixed_noise=(t, eps), remat=mode,
                                ema_decay=TRAIN_EMA,
                                on_step=lambda i, v: losses.append(v))
        return times, state, losses

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
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        marks = len(programs.CAPTURES), len(CAPTURE_RSS)
        with no_sync_in_eager_runs():
            times, state, losses = run(mode)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        pool = programs.pool_bytes(dev)
        captured = captures_since(*marks)
        got = _read(counters)
        for k, v in got.items():
            total[k] += v
        if got != _want(attn=3 * per_step[mode]) or times.launches != [
                per_step[mode]] * 3:
            raise AssertionError(f"i {mode}: launches {got} over three steps "
                                 f"({times.launches} a step), want "
                                 f"{_want(attn=3 * per_step[mode])}")
        if [c[0] for c in captured] != ["train_step"]:
            raise AssertionError(f"i {mode}: captures {captured}, want one "
                                 "train_step program")
        if not (np.isfinite(losses).all() and losses[2] < losses[0]):
            raise AssertionError(f"i {mode}: losses {losses}")
        if abs(losses[0] - loss0) > 1e-3 * abs(loss0):
            raise AssertionError(f"i {mode}: first step loss {losses[0]} "
                                 f"against its gradient step's {loss0}")
        result = (snapshot(state), losses)
        del state
        _free()
        eager_times, eager_state, eager_losses = run(mode, eager=True)
        want = (snapshot(eager_state), eager_losses)
        del eager_state
        _free()
        replay_check(f"i {mode}", result, want)
        del result, want
        _free()
        modes[mode] = dict(step_ms=float(np.median(times.ms)),
                           steps_ms=times.ms, eager_steps_ms=eager_times.ms,
                           losses=losses, peak_gib=peak / 2**30,
                           resident_gib=resident / 2**30,
                           launches_per_step=times.launches[-1],
                           grad_rel_rms_vs_none=rel,
                           capture_s=captured[0][1],
                           capture_rss_bytes=captured[0][2],
                           pool_bytes=pool)
        log(f"  request i, remat {mode}: step ms {times.ms[0]:.1f} (eager "
            f"run and capture {captured[0][1]:.2f} s, host RSS "
            f"+{captured[0][2] / 2**20:.1f} MiB, pool "
            f"{pool / 2**30:.2f} GiB) / {times.ms[1]:.1f} / "
            f"{times.ms[2]:.1f} replayed; eager "
            f"{[round(v, 1) for v in eager_times.ms]}; losses "
            f"{[round(v, 5) for v in losses]}; peak {peak / 2**30:.2f} GiB "
            f"({resident / 2**30:.2f} GiB resident before); kernel A "
            f"launches per step {times.launches}; gradients rel-RMS "
            f"{rel:.3e} from none's; three steps bit for bit the eager "
            f"body's ({card})")
    first = [m["losses"][0] for m in modes.values()]
    if max(first) - min(first) > 1e-3 * abs(first[0]):
        raise AssertionError(f"i: first-step losses {first} differ by more "
                             "than relative 1e-3")

    # AdamW's update in the card's form (capturable, a tensor learning
    # rate) against the CPU's (not capturable), from "none"'s gradients
    adamw = adamw_form_gap(model0, ref, TRAIN_LR, 0.01)
    log(f"  request i: one AdamW update, capturable against the CPU's "
        f"form, at full width: update rel-RMS {adamw['update_rel_rms']:.3e}"
        f", {100 * adamw['share_differing']:.3f} % of elements differ, "
        f"max-abs {adamw['max_abs']:.3e} ({card})")
    _free()
    # the device clip on bf16 gradients past the clip, against the host
    # float's clip it replaced (fp32 arithmetic, one rounding each)
    clip_grads = [g[:256].clone() * 1e3 for g in ref[:64]]
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(clip_grads)).float())
    host = [g.clone() for g in clip_grads]
    torch._foreach_div_(host, float(norm))
    tstep.clip_by_global_norm_(clip_grads, norm, 1.0)
    if float(norm) < 1.0 or not all(torch.equal(a, b)
                                    for a, b in zip(clip_grads, host)):
        raise AssertionError("i: the device clip on bf16 gradients is not "
                             "the host float's bit for bit")
    del clip_grads, host
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
    return dict(modes=modes, grad_rel_rms=gaps, adamw_forms=adamw,
                launches=total)


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
    """Request (k): three `distill` steps from the published 24-layer
    teacher (models.dit, seeded random bf16 weights) into a student of the
    same size, num_student_steps=8, substeps=5, plain and then
    quant-aware, through the distill step's program (train/distill.py
    DISTILL_PROGRAMS, owned by the student's state and the teacher): step
    1 its eager run under torch.cuda.set_sync_debug_mode("error") and its
    capture (seconds, host VmRSS growth, the pool's bytes after), steps 2
    and 3 replays.  Per step kernel A launches 5 x 24 times for the
    teacher (no grad, 3B rows) and 24 for the student (under grad); no
    kernel C (QAT runs through qat_dot).  The replay check: the same
    three steps with the body called eagerly, from the same weights and
    draws, bit for bit (replay_check).  Prints the losses, the step ms,
    the peak memory.  Returns (launch counts, the quant-aware student,
    results)."""
    import itertools

    import torch
    from echo_tts_torch.train import distill as tdistill
    from echo_tts_torch.utils import programs

    n_layers = models.dit_cfg.num_layers
    per_step = (5 + 1) * n_layers
    total = dict.fromkeys(counters, 0)
    results = {}

    def run(quant_aware: bool, eager: bool = False) -> tuple:
        losses = []
        with StepTimes(tdistill, "make_distill_step", eager=eager) as times:
            state = tdistill.distill(
                models.dit, itertools.repeat(batch), num_steps=3,
                num_student_steps=8, substeps=5, quant_aware=quant_aware,
                on_step=lambda i, v: losses.append(v))
        return times, state, losses

    for quant_aware in (False, True):
        student = None                      # the plain one goes first
        name = "quant-aware" if quant_aware else "plain"
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        marks = len(programs.CAPTURES), len(CAPTURE_RSS)
        with no_sync_in_eager_runs():
            times, state, losses = run(quant_aware)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        pool = programs.pool_bytes(torch.device("cuda"))
        captured = captures_since(*marks)
        got = _read(counters)
        for k, v in got.items():
            total[k] += v
        if (got != _want(attn=3 * per_step) or times.launches != [per_step] * 3
                or not np.isfinite(losses).all()):
            raise AssertionError(f"k {name}: launches {got} "
                                 f"({times.launches} a step), want "
                                 f"{_want(attn=3 * per_step)}; losses {losses}")
        if [c[0] for c in captured] != ["distill_step"]:
            raise AssertionError(f"k {name}: captures {captured}, want one "
                                 "distill_step program")
        result = (snapshot(state), losses)
        del state
        _free()
        eager_times, eager_state, eager_losses = run(quant_aware, eager=True)
        replay_check(f"k {name}", result,
                     (snapshot(eager_state), eager_losses))
        del result
        results[name] = dict(losses=losses, steps_ms=times.ms,
                             eager_steps_ms=eager_times.ms,
                             peak_gib=peak / 2**30,
                             resident_gib=resident / 2**30,
                             launches_per_step=times.launches[-1],
                             capture_s=captured[0][1],
                             capture_rss_bytes=captured[0][2],
                             pool_bytes=pool)
        log(f"  request k, {name}: losses {[round(v, 5) for v in losses]}; "
            f"step ms {times.ms[0]:.1f} (eager run and capture "
            f"{captured[0][1]:.2f} s, host RSS "
            f"+{captured[0][2] / 2**20:.1f} MiB, pool {pool / 2**30:.2f} GiB)"
            f" / {times.ms[1]:.1f} / {times.ms[2]:.1f} replayed; eager "
            f"{[round(v, 1) for v in eager_times.ms]}; peak "
            f"{peak / 2**30:.2f} GiB ({resident / 2**30:.2f} resident before);"
            f" kernel A per step {times.launches} (teacher 5 x {n_layers} at "
            f"GB = 6 without grad, student {n_layers} under grad); three "
            f"steps bit for bit the eager body's ({card})")
        # the eager run's student, bit for bit the program's
        student = eager_state.model
        del eager_state
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
    t0 = time.perf_counter()
    serve_models.clear_models()
    _free()
    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)

    def add(got):
        for k, v in got.items():
            launches[k] += v

    train = request_train(counters, card)
    add(train["launches"])
    stamp("request i")
    models = pl.random_models()
    got, data_loss = request_data(models, counters)
    add(got)
    stamp("request j")
    got, student, distill = request_distill(
        models, train_batch(models.dit_cfg, seed=62), counters, card)
    add(got)
    stamp("request k")
    got, bundle = request_bundle(models, student, counters)
    add(got)
    stamp("request l")
    del student
    _free()
    add(request_demo(models, counters))
    log(f"  training requests' peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB since the "
        f"last reset; (i)-(m) {time.perf_counter() - t0:.1f} s")
    return launches, dict(train=train["modes"],
                          grad_rel_rms=train["grad_rel_rms"],
                          adamw_forms=train["adamw_forms"],
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
TRAIN_DEPTH = 4           # (n), (o)'s train steps: DiT layers (encoders 2)


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
    with the mesh three times: its body without the program (`.eager`),
    the program's miss (its eager run and capture) and a replay, each
    call's latents bit for bit (b)'s and 960 kernel A launches.  On the
    same world: the NCCL collectives inside a graph (world1_collectives)
    and the mesh train program (world1_train).  Then, on the same inputs,
    the fp32 sampler (plain attention) that request (o) holds its TP=2
    latents to, and the fp32 CFG forward its TP=2 forward is measured
    against.  Returns (launches, the fp32 latents, the fp32 forward)."""
    import torch
    import torch.distributed as dist
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.parallel import distributed as pdist
    from echo_tts_torch.parallel import inference as pinf
    from echo_tts_torch.pipeline import pipeline as pl
    from echo_tts_torch.sampler.euler import (
        sample_euler_cfg_independent_guidances as sample)
    from echo_tts_torch.tools import parallel_checks as pc
    from echo_tts_torch.utils import programs

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
    n_attn = models.dit_cfg.num_layers * SAMPLER_DEFAULTS["num_steps"]
    total = dict.fromkeys(counters, 0)
    try:
        if not pdist.initialize_from_env() or dist.get_backend() != "nccl":
            raise AssertionError("n: initialize_from_env did not join NCCL")
        mesh = pdist.global_mesh(tp=1)
        models = pinf.shard_models(models, mesh)
        placed = pinf.place_request(mesh, req_b["spk"], req_b["smask"],
                                    req_b["ids"], req_b["tmask"], noise)
        walls = {}
        n_captures = len(programs.CAPTURES)
        for form in ("eager", "miss", "replay"):
            fn = sample.eager if form == "eager" else sample
            _reset(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat = fn(models.dit, *placed[:4], initial_noise=placed[4],
                     dtype=models.dtype, mesh=mesh, **SAMPLER_DEFAULTS)
            torch.cuda.synchronize()
            walls[form] = (time.perf_counter() - t0) * 1e3
            got = _read(counters)
            if got != _want(attn=n_attn):
                raise AssertionError(f"n {form}: launches {got}, want "
                                     f"{_want(attn=n_attn)}")
            if not torch.equal(lat, req_b["latents"]):
                raise AssertionError(f"n {form}: the world-size-1 latents "
                                     "differ from request (b)'s")
            for k, v in got.items():
                total[k] += v
        captured = [c for c in programs.CAPTURES[n_captures:]
                    if c[0] == "euler"]
        if len(captured) != 1:
            raise AssertionError(f"n: mesh sampler captures {captured}, want "
                                 "one")
        world = dist.get_world_size()
        log(f"  request n: NCCL world of {world}, global_mesh(tp=1), request "
            f"(b) through shard_models/place_request and the mesh sampler: "
            f"eager {walls['eager']:.1f} ms, program miss (eager run and "
            f"capture, {captured[0][1]:.2f} s) {walls['miss']:.1f} ms, "
            f"replay {walls['replay']:.1f} ms; each bit-equal to (b)'s "
            f"latents, 960 kernel A launches each ({card})")
        world1_collectives(mesh, models.dit, card)
        _reset(counters)
        world1_train(mesh, dev, card)
        torch.cuda.synchronize()
        for k, v in _read(counters).items():
            total[k] += v
    finally:
        pdist.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v

    # the fp32 run on (b)'s inputs (plain attention: kernel A takes bf16)
    _reset(counters)
    lat32, fwd32 = pc.fp32_refs(models.dit, req_b)
    torch.cuda.synchronize()
    if _read(counters) != _want():
        raise AssertionError("n: the fp32 run launched a kernel")
    del models
    _free()
    return total, lat32, fwd32


def world1_collectives(mesh, owner, card: str) -> None:
    """Request (n): a program over the NCCL mesh whose body runs
    dist.all_reduce and dist.all_gather_into_tensor on the one-rank world
    group (parallel_checks.collectives_check), the only NCCL collectives
    inside a graph this one card can show: its miss and a replay on other
    inputs, each equal to the body run eagerly on the same inputs."""
    from echo_tts_torch.tools import parallel_checks as pc

    rec = pc.collectives_check(mesh, owner)
    if not (rec["miss_bit_equal"] and rec["replay_bit_equal"]):
        raise AssertionError(f"n: the collectives' program differs from its "
                             f"body: {rec}")
    if next(owner.parameters()).is_cuda and rec["captures"] != 1:
        raise AssertionError(f"n: collectives' program captures {rec}, "
                             "want one")
    log(f"  request n: all_reduce and all_gather_into_tensor over NCCL in "
        f"a captured program (capture {rec['capture_s']:.4f} s): miss and "
        f"replay equal to the body's ({card})")


def world1_train(mesh, dev, card: str) -> None:
    """Request (n): three train steps (remat "attn", an EMA) of the DiT
    cut to TRAIN_DEPTH layers on the world-size-1 mesh, through the mesh
    train program (its miss, two replays) and through `.eager` from an
    identical state: after each step the loss, parameters, AdamW moments
    and EMA bit for bit, TRAIN_DEPTH kernel A launches a step."""
    import torch
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.ops.joint_attention import fused_joint_attention
    from echo_tts_torch.tools import parallel_checks as pc
    from echo_tts_torch.tools.train_checks import train_draws
    from echo_tts_torch.train import step as tstep

    cfg = pc.cut_config(TRAIN_DEPTH)
    model = tdit.init_dit(cfg, device=dev, seed=1)
    batch, t, eps = train_draws(cfg, seed=0, device=dev)
    tx = tstep.make_optimizer(lr=TRAIN_LR)
    step = tstep.make_train_step(tx, ema_decay=TRAIN_EMA, mesh=mesh)
    states = [tstep.create_train_state(model, tx, ema=True, mesh=mesh)
              for _ in range(2)]
    ms = {"program": [], "eager": []}
    for i in range(3):
        losses = []
        for form, state in zip(ms, states):
            run = step if form == "program" else step.eager
            n0 = fused_joint_attention.launches
            (_, loss), wall = pc.wall_ms(lambda: run(state, batch, t=t,
                                                     eps=eps))
            n = fused_joint_attention.launches - n0
            if n != TRAIN_DEPTH:
                raise AssertionError(f"n train {form} step {i}: kernel A "
                                     f"launches {n}, want {TRAIN_DEPTH}")
            ms[form].append(wall)
            losses.append(loss)
        if not (pc.same(losses[0], losses[1]) and pc.same(
                *(pc.state_tensors(s) for s in states))):
            raise AssertionError(f"n train step {i}: the mesh program's "
                                 "state differs from the eager body's")
    log(f"  request n: mesh train program at {TRAIN_DEPTH} layers, three "
        f"steps bit for bit the eager body's (loss {float(losses[0]):.6f}; "
        f"parameters, moments, EMA): program "
        f"{[round(v, 1) for v in ms['program']]} ms (miss, replays), eager "
        f"{[round(v, 1) for v in ms['eager']]} ms ({card})")
    del states, model
    _free()


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
    req2 = pc.request_inputs(dev, batch=2)
    if rank == 0:
        # the program refuses the gloo mesh before it runs anything, so
        # rank 1 waits in no collective
        try:
            pc.sample(model, req2, dp2)
        except RuntimeError as exc:
            res["refusal"] = str(exc)
        else:
            raise AssertionError("o: the mesh sampler's program ran over "
                                 "gloo on the card")
        if "'gloo'" not in res["refusal"]:
            raise AssertionError(f"o: the refusal does not name the "
                                 f"backend: {res['refusal']}")
        done("refusal")
    res["sp"] = pc.sp_check(model, tp2, eager=True)
    done("sp")
    ref2, res["dp_unsharded_ms"] = pc.wall_ms(lambda: pc.sample(model, req2))
    res["dp"] = pc.dp_sample_check(model, dp2, req2, ref2, eager=True)
    done("dp")
    del ref2
    req_b = {k: v.to(dev) for k, v in payload["req_b"].items()}
    res["tp_forward"] = pc.tp_forward_check(
        model, tp2, req_b, payload["fp32_forward"].to(dev))
    done("tp_forward")
    pc.reset_launches()
    lat, ms = pc.wall_ms(lambda: pc.sample(model, req_b, tp2, eager=True))
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
    res["train_tp"] = pc.train_check(cfg, tp2, batch, t, eps, dev,
                                     eager=True)
    done("train_tp")
    res["train_dp"] = pc.train_check(cfg, dp2, batch, t, eps, dev,
                                     eager=True)
    done("train_dp")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def request_two_ranks(req_b: dict, lat32, fwd32, card: str) -> tuple:
    """Request (o): two ranks on the one card (torch.multiprocessing spawn,
    a gloo world: NCCL refuses two ranks on one device).  Rank 0 first
    calls the mesh sampler over the gloo mesh: its program must refuse it
    on the card, naming the backend (a graph records no gloo collective).
    Then every check runs through the mesh cores' eager forms (`.eager`),
    each rank building the published DiT from seed 0 and its unsharded
    references on the card:
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
    log(f"  request o: rank 0's mesh sampler over gloo refused: "
        f"{ranks[0]['refusal']!r}")
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


def programs_only(card: str) -> int:
    """Request (b) at full width, then request (z) alone; one
    {"programs": ...} line with every cache's counts."""
    import torch
    from echo_tts_torch import SAMPLER_DEFAULTS
    from echo_tts_torch.pipeline import audio_io, pipeline as pl
    from echo_tts_torch.utils import programs

    models = pl.random_models()
    req_b = {}
    sample_fn = functools.partial(pl.euler_sample_fn, **SAMPLER_DEFAULTS)

    def recording_b(models_, spk, smask, ids, tmask, seed):
        out = sample_fn(models_, spk, smask, ids, tmask, seed)
        req_b.update(spk=spk, smask=smask, ids=ids, tmask=tmask, seed=seed,
                     latents=out.clone())
        return out

    pl.sample_pipeline(models, recording_b, TEXT, audio_io.load_audio(VOICE), 1)
    torch.cuda.synchronize()
    request_programs(models, req_b, kernel_counters(), card)
    print(json.dumps({"programs": programs.stats()}), flush=True)
    return 0


def main(argv) -> int:
    t_start = time.perf_counter()
    import torch
    card = phase_device()
    phase_build()
    install_program_notes()
    if "--programs-only" in argv:
        return programs_only(card)
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
        stamp("phase 3, training")
        got, scaled = phase_scale_out(card, req_b)
        for k, v in got.items():
            launches[k] += v
        stamp("phase 3, scale-out")
    att, att8, att_bwd, rst, mm = phase_kernels()
    stamp("phase 4")
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
            # request (t)'s B = 8 pass over the 6400-latent bucket (T =
            # 2368), GB = 24 and 8, bf16 and int8 static K/V
            long_speaker_b8={
                r["shape"]: summary(r) for r in att + att8
                if r["shape"].startswith(("GB=24 S=640 T=2368",
                                          "GB=8 S=640 T=2368"))},
            # request (u)'s short request (S = 224, T = 928) and request
            # (w)'s 2816-latent speaker bucket (S = 640, T = 1568)
            short_and_2816={r["shape"]: summary(r) for r in att
                            if r["shape"].startswith((
                                "GB=3 S=224 T=928", "GB=1 S=224 T=928",
                                "GB=3 S=640 T=1568", "GB=1 S=640 T=1568"))},
            # request (x): T = 40, 20 of 24 text columns valid
            validate={r["shape"]: summary(r) for r in att
                      if r["shape"].startswith(("GB=3 S=160 T=40 ",
                                                "GB=1 S=160 T=40 "))},
            # request (y): the B = 8 pass at T = 928, the streamed blocks
            # at T = 1248
            bench={r["shape"]: summary(r) for r in att
                   if r["shape"].startswith(("GB=24 S=640 T=928",
                                             "GB=8 S=640 T=928"))
                   or f" T={BENCH_STREAM_T} " in r["shape"]},
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
                           "unrolled_ms"),
            # request (x)'s 32-latent round trip
            validate={r["shape"]: summary(r, "unrolled_ms") for r in rst
                      if any(r["shape"] == res_shape(*v)
                             for v in VALIDATE_RES)},
            # request (y)'s decodes, batch-4 slices and streamed blocks
            bench={r["shape"]: summary(r, "unrolled_ms") for r in rst
                   if r["shape"] in bench_res_shapes()}),
        # M=1920 (a CFG step), w1/w3 (2048 -> 5888); max_abs_err is the
        # fp32 output's
        kernel_entry(
            "int8_matmul", "echo_tts_torch/csrc/int8_matmul.cu",
            "echo_tts_tpu/ops/pallas/int8_matmul.py:44 (_kernel)", mm, mm[0],
            launches["int8_matmul"],
            max_abs_err_bf16=max(r["max_abs_err_bf16"] for r in mm),
            prepass_ms=mm[0]["prepass_ms"],
            bf16_matmul_ms=mm[0]["bf16_matmul_ms"],
            # request (u)'s B = 8 pass (M = 15360 and 5120) and short
            # request (M = 672 and 224), request (t)'s M = 120 scan, and
            # request (x) (M = 480 and 160)
            by_shape={r["shape"]: summary(r, "prepass_ms", "bf16_matmul_ms")
                      for r in mm if r["shape"].startswith(
                          ("M=15360 ", "M=5120 ", "M=672 ", "M=224 ",
                           "M=120 ", "M=480 ", "M=160 "))}),
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
    from echo_tts_torch.utils import programs
    log(f"programs: host RSS {host_rss()} bytes, grown "
        f"{sum(b - a for _, a, b in CAPTURE_RSS)} bytes over the captures")
    log(f"programs: {len(programs.CAPTURES)} captured in "
        f"{sum(s for _, s in programs.CAPTURES):.1f} s "
        f"({ {c.name: (c.misses, c.hits) for c in programs.caches()} } "
        f"misses, hits)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
