"""Seconds of set-up spent building programs: the program's
`program.build` spans (each miss's eager run and its capture) that ended
before the traced window."""
from benchmark import spans


def read(ctx):
    return spans.program_build_s(ctx)
