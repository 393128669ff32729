"""Kernel A (csrc/joint_attention.cu): the bound of the window's calls,
counted from the passes' shapes, over its device time (%)."""
from benchmark import counts, readers

KERNELS = ("joint_attention_kernel",)


def read(ctx):
    return readers.roofline(ctx, readers.attention_calls(ctx),
                            counts.PEAK_BF16, *KERNELS)
