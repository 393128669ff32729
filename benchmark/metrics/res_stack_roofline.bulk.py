"""Kernel B (csrc/res_stack.cu, three unit launches a call): the bound of
the window's decode calls over their device time (%)."""
from benchmark import counts, readers

KERNELS = ("res_unit_kernel",)


def read(ctx):
    return readers.roofline(ctx, readers.res_stack_calls(ctx),
                            counts.PEAK_BF16, *KERNELS)
