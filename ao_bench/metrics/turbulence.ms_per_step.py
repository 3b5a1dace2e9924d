"""turbulence.ms_per_step: device time a step of the operations launched in
the program's ``turbulence`` span (the frozen-flow sample or the
conditional flow's advance, and the piston removal): their summed
durations in the traced episode over its steps.  Nothing without the
program's spans."""

from ao_bench import spans


def read(ctx):
    v = spans.view(ctx)
    return None if v is None else v.layer_ms_per_step("turbulence")
