"""Kernel C (csrc/int8_matmul.cu), its row-quantising pre-pass included:
the bound of the window's calls at the int8 peak over their device time (%)."""
from benchmark import counts, readers

KERNELS = ("int8_matmul_kernel", "int8_quantize_rows_kernel")


def read(ctx):
    return readers.roofline(ctx, readers.int8_matmul_calls(ctx),
                            counts.PEAK_INT8, *KERNELS)
