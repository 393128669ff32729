"""Programs captured inside the window (utils/programs.stats() misses over
every cache, the window's change): 0 when set-up warmed every shape."""


def read(ctx):
    return float(sum(v["misses"] for v in ctx.program_stats.values()))
