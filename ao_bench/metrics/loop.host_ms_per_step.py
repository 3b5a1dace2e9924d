"""loop.host_ms_per_step: the median over the traced episode's steps of
the host time of the program's ``loop.step`` span outside every CUDA
runtime and driver call: Python, the dispatcher and the program's own
logic, the part of a step that a CUDA graph would remove.  Nothing
without the program's spans."""

from ao_bench import spans


def read(ctx):
    v = spans.view(ctx)
    return None if v is None else v.host_ms_per_step()
