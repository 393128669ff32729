"""The device's idle time while no span was open on the server's
thread, over the traced window (%): what the program's spans cannot
account for."""
from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "untraced")
