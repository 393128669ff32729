"""The device's idle time while the server's thread ran a pass's host
work (`server.pass` and its children: run_batch's stages, the device
lock, resolving the futures), over the traced window (%)."""
from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "host")
