"""Dia's model FLOPs over the window's passes (the encoder, the prompt
prefill and the decode steps of each real request, both of its rows, at
its real lengths: benchmark/dia_counts.py) over window x the bf16 peak
(%).  Reads the passes whose `dia.*` spans the program kept."""
from benchmark import dia_counts


def read(ctx):
    cfg = ctx.cell.config["dia"]
    passes = [p for p in ctx.passes if "dia.decode" in getattr(
        p, "stages", {})]
    if not passes or ctx.trace.window_s <= 0:
        return None
    flops = sum(sum(dia_counts.request_flops(
        cfg, p.text_lengths[i], p.prompt_frames[i], p.frames[i]).values())
        for p in passes for i in p.real_rows())
    return 100.0 * flops / (ctx.trace.window_s * dia_counts.PEAK_BF16)
