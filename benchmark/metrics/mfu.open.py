"""The open-loop cell's sampler FLOPs over window x peak (%)."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
