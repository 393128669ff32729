"""Operations and bytes per kernel call, and model FLOPs per pass, from
shapes alone.

The kernels' counts follow the port's kernel table (chip_smoke.py phase 4):
each input byte read once and each output byte written once.  A bound is
max(ops / peak, bytes / bandwidth) at the H100 SXM's published dense
peaks.  `sampler_pass_flops` is the useful forward count of
examples/bench_train_step.py `useful_fwd_tflop` (the DiT trunk's weight
products and its attention over [self | text | speaker], the text and
speaker encoders), per Euler step at its rows, plus the static K/V
projections of the prefill; it leaves out the conditioning MLP, the
in/out projections and the codec, so it is a floor.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

PEAK_BF16 = 989e12      # FLOP/s, dense
PEAK_INT8 = 1979e12     # OP/s, dense
PEAK_BYTES = 3.35e12    # bytes/s
HEAD_DIM = 128


def bound_s(ops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    return max(ops / peak, nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def attention(gb: int, s: int, t: int, b: int, h: int,
              dh: int = HEAD_DIM) -> Tuple[float, float]:
    """Kernel A, one call: q-batch gb over a static K/V batch b of t
    columns, s self columns.  bf16 q, k_self, v_self, out; bf16 static
    K/V; the (gb, t) mask; the (t,) column scale."""
    ops = 4.0 * gb * h * s * (s + t) * dh
    nbytes = 4 * gb * s * h * dh * 2 + 2 * b * t * h * dh * 2 + gb * t + t * 4
    return ops, nbytes


def res_stack(c: int, length: int, batch: int) -> Tuple[float, float]:
    """Kernel B, one call (three dilated residual units at width c)."""
    ops = 3 * 2.0 * 8 * c * c * length * batch
    nbytes = 2 * batch * length * c * 2 + 3 * 8 * c * c * 2 + 3 * 4 * c * 2
    return ops, nbytes


def int8_matmul(m: int, k: int, n: int) -> Tuple[float, float]:
    """Kernel C, one call with its row-quantising pre-pass: x bf16, w int8,
    w_scale fp32 read once; out bf16 written once."""
    return 2.0 * m * k * n, m * k * 2 + n * k + n * 4 + m * n * 2


# ---------------------------------------------------------------------------
# A sampler pass and a decode
# ---------------------------------------------------------------------------

def cfg_steps(sampler: dict) -> int:
    """Steps with guidance (3 rows a request); the rest run 1 row."""
    n = sampler["num_steps"]
    t = (np.linspace(1.0, 0.0, n + 1, dtype=np.float32)
         * np.float32(0.999))[:-1]
    return int(np.sum((t >= np.float32(sampler["cfg_min_t"]))
                      & (t <= np.float32(sampler["cfg_max_t"]))))


def step_rows(sampler: dict, batch: int) -> List[int]:
    """The q-batch of each step: 3B on guided steps, B else."""
    g = cfg_steps(sampler)
    return [3 * batch] * g + [batch] * (sampler["num_steps"] - g)


def static_columns(dit: dict, text_len: int, speaker_len: int) -> int:
    return text_len + speaker_len // dit["speaker_patch_size"]


def attention_calls(dit: dict, sampler: dict, batch: int, seq: int,
                    text_len: int, speaker_len: int) -> List[Tuple]:
    """(gb, s, t, b, h) of every kernel A call of one sampler pass."""
    t = static_columns(dit, text_len, speaker_len)
    return [(gb, seq, t, batch, dit["num_heads"])
            for gb in step_rows(sampler, batch)
            for _ in range(dit["num_layers"])]


def int8_matmul_calls(dit: dict, sampler: dict, batch: int,
                      seq: int) -> List[Tuple[int, int, int]]:
    """(m, k, n) of every kernel C call of one W8A8 sampler pass: the eight
    hot linears of every layer on every step."""
    m_, f = dit["model_size"], dit["intermediate_size"]
    shapes = [(m_, m_)] * 5 + [(m_, f), (m_, f), (f, m_)]
    return [(gb * seq, k, n) for gb in step_rows(sampler, batch)
            for _ in range(dit["num_layers"]) for k, n in shapes]


def res_stack_calls(codec: dict, batch: int, latents: int,
                    max_width: int = 384) -> List[Tuple[int, int, int]]:
    """(c, length, batch) of every kernel B call of one decode: the decoder
    blocks' residual stacks at widths the kernel takes (<= 384)."""
    length = latents
    for f in codec["downsample_factor"]:
        length *= f
    calls = []
    for bi, stride in enumerate(codec["decoder_rates"]):
        length *= stride
        c = codec["decoder_dim"] // 2 ** (bi + 1)
        if c <= max_width:
            calls.append((c, length, batch))
    return calls


def sampler_pass_flops(dit: dict, sampler: dict, batch: int, seq: int,
                       text_len: int, speaker_len: int) -> Dict[str, float]:
    """Useful FLOPs of one sampler pass over `batch` requests, split into
    the hot linears (the eight W8A8 quantizes: wq, wk, wv, wo, gate, w1,
    w2, w3 of every layer) and the rest (attention, encoders, static K/V
    projections)."""
    m, f, layers = dit["model_size"], dit["intermediate_size"], dit["num_layers"]
    t_static = static_columns(dit, text_len, speaker_len)
    linear_macs = attn_macs = 0.0
    for gb in step_rows(sampler, batch):
        linear_macs += layers * (5 * m * m + 3 * m * f) * gb * seq
        attn_macs += layers * 2 * (seq + t_static) * m * gb * seq

    def enc(tokens, d, inter, n_layers):
        return n_layers * (5 * d * d + 3 * d * inter + tokens * d) * tokens

    patches = speaker_len // dit["speaker_patch_size"]
    prefill = batch * (
        enc(text_len, dit["text_model_size"], dit["text_intermediate_size"],
            dit["text_num_layers"])
        + enc(patches, dit["speaker_model_size"],
              dit["speaker_intermediate_size"], dit["speaker_num_layers"])
        + layers * 2 * m * (dit["text_model_size"] * text_len
                            + dit["speaker_model_size"] * patches))
    return {"linear": 2 * linear_macs, "other": 2 * (attn_macs + prefill)}
