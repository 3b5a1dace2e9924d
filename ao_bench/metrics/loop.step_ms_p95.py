"""loop.step_ms_p95: the 95th percentile over the traced episode's steps
of a step's device time: from the device start of the step's first
operation to the next step's (the last step to the end of its last
operation), steps told apart by the program's ``loop.step`` spans.
Nothing without them."""

import statistics

from ao_bench import spans


def read(ctx):
    v = spans.view(ctx)
    ms = [] if v is None else v.step_ms()
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
