"""The p90 of the requests' wait in the server's queue (the program's
`server.queue` spans, submit to dispatch) over the requests dispatched in
the window, nearest rank, in ms."""
from benchmark import spans


def read(ctx):
    return spans.queue_wait_p90_ms(ctx)
