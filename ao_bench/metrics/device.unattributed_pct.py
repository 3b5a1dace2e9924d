"""device.unattributed_pct: the share of the traced episode's device
time, summed over its operations, launched outside every layer span of
the program (turbulence, synthesis, measure, estimate, solve,
telemetry): the spans' coverage, near 0 while they tile the step.
Nothing without the program's spans."""

from ao_bench import spans


def read(ctx):
    v = spans.view(ctx)
    return None if v is None else v.unattributed_pct()
