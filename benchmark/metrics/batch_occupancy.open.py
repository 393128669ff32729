"""Requests a server pass carried over the window: MicroBatchServer.stats()
completed over batches, the window's change."""


def read(ctx):
    b = ctx.server_stats["batches"]
    return ctx.server_stats["completed"] / b if b else None
