"""The share of the Dia cell's traced window in which no device operation
ran (%)."""
from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
