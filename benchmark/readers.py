"""The arithmetic the per-layer readers share (benchmark/metrics/*.py).

Each reader gets a harness.Context: the traced window (device intervals
by kernel name, host spans), the window's passes as the benchmark's spans
recorded them (loops/serving.Pass: the rows, the text and speaker
lengths as launched and as real, the decode batches), and the window's
change in the server's and the programs' counters.  Work is counted from
those shapes (benchmark/counts.py): useful FLOPs from the real requests'
real lengths, a kernel's roofline work from what was launched; time is
read from the trace.  A reader that finds nothing to read returns None.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

from . import counts


def mfu(ctx) -> Optional[float]:
    """The window's useful sampler FLOPs over (window x peak), in %: each
    real request at its own text and speaker lengths.  Under W8A8 the hot
    linears are held to the int8 peak, the rest to bf16's."""
    cfg = ctx.cell.config
    if not ctx.passes or ctx.trace.window_s <= 0:
        return None
    linear_peak = (counts.PEAK_INT8 if cfg["dit_quant"] == "int8"
                   else counts.PEAK_BF16)
    least = 0.0
    for p in ctx.passes:
        for i in p.real_rows():
            f = counts.sampler_pass_flops(
                cfg["dit"], cfg["sampler"], 1, p.seq, p.text_lengths[i],
                p.speaker_lengths[i])
            least += f["linear"] / linear_peak + f["other"] / counts.PEAK_BF16
    return 100.0 * least / ctx.trace.window_s


def roofline(ctx, calls: Callable[[object], Iterable[Tuple[float, float]]],
             peak: float, *kernels: str) -> Optional[float]:
    """Sum over the window's calls of their bound, over the device time of
    the named kernels, in %."""
    t = ctx.trace.kernel_s(*kernels)
    if t <= 0:
        return None
    least = sum(counts.bound_s(ops, nbytes, peak)
                for p in ctx.passes for ops, nbytes in calls(p))
    return 100.0 * least / t


def attention_calls(ctx):
    """Kernel A's calls of a pass, at the text and speaker widths launched."""
    cfg = ctx.cell.config

    def calls(p):
        return [counts.attention(*c) for c in counts.attention_calls(
            cfg["dit"], cfg["sampler"], p.rows, p.seq, p.text_width,
            p.speaker_width)]
    return calls


def int8_matmul_calls(ctx):
    cfg = ctx.cell.config

    def calls(p):
        return [counts.int8_matmul(*c) for c in counts.int8_matmul_calls(
            cfg["dit"], cfg["sampler"], p.rows, p.seq)]
    return calls


def res_stack_calls(ctx):
    """Kernel B's calls of a pass's decodes, at the batches launched."""
    codec = ctx.cell.config["codec"]

    def calls(p):
        return [counts.res_stack(*c) for b in p.decode_batches
                for c in counts.res_stack_calls(codec, b, p.seq)]
    return calls


def idle_share(ctx) -> Optional[float]:
    w = ctx.trace.window_s
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / w)
