"""loop.launch_queue_ms: the median over the traced episode's steps of
the time from the host's launch of a step's first device operation to
its device start: how far ahead of the card the host runs (near the
launch latency when the card waits on the host).  Nothing without the
program's spans."""

from ao_bench import spans


def read(ctx):
    v = spans.view(ctx)
    return None if v is None else v.launch_queue_ms()
