"""Kernel B's centred instance (csrc/res_stack.cu, three unit launches a
call) in Dia's codec decode: the bound of the window's calls (counts.
res_stack's operations and bytes, each row at its own length, the decode
batches from the program's `batch.decode` spans) over the kernel's device
time (%)."""
from benchmark import counts, dia_counts

KERNELS = ("res_unit_kernel",)


def read(ctx):
    codec = ctx.cell.config["codec"]
    t = ctx.trace.kernel_s(*KERNELS)
    if t <= 0:
        return None
    least = 0.0
    for p in ctx.passes:
        i = 0
        for b in getattr(p, "decode_batches", []):
            for ops, nbytes in dia_counts.res_stack_calls(codec,
                                                         p.frames[i:i + b]):
                least += counts.bound_s(ops, nbytes, counts.PEAK_BF16)
            i += b
    if least <= 0:
        return None
    return 100.0 * least / t
