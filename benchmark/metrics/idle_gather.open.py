"""The device's idle time while the server held a batch open for more
rows (`server.gather`, the 50 ms wait for the next request), over the
traced window (%)."""
from benchmark import spans


def read(ctx):
    return spans.idle_share(ctx, "gather")
