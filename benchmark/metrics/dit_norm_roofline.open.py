"""Kernel D (csrc/dit_norm.cu: the DiT layer's AdaLN twice and its Q/K
norm with RoPE once, every layer of every Euler step): the bound of the
window's calls over the device time of its two kernels (%).  Only the
activations' bytes are counted, a floor: each AdaLN call reads and writes
gb * S * M bf16 and reads the 2 * gb * M of shift and scale, each Q/K call
reads and writes 2 * gb * S * M (the norm weights and the RoPE table, a
few KB, are left out).  None where the trace holds no kernel D."""
from benchmark import counts, readers

KERNELS = ("dit_adaln_kernel", "dit_qk_rope_kernel")


def calls(ctx):
    """(ops, bytes) of every kernel D call of a pass."""
    cfg = ctx.cell.config
    dit, m = cfg["dit"], cfg["dit"]["model_size"]

    def per_pass(p):
        out = []
        for gb in counts.step_rows(cfg["sampler"], p.rows):
            e = gb * p.seq * m
            layer = [(0.0, 2 * (2 * e + 2 * gb * m))] * 2 + [(0.0, 2 * 4 * e)]
            out += layer * dit["num_layers"]
        return out
    return per_pass


def read(ctx):
    return readers.roofline(ctx, calls(ctx), counts.PEAK_BF16, *KERNELS)
