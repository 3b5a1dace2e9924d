"""telemetry.ms_per_step: device time a step of the operations launched in
the program's ``telemetry`` span (the DM volts, predicted states, cost,
residual RMS, Strehl and norms a step, and the outputs' stack after the
last step): their summed durations in the traced episode over its steps.
Nothing without the program's spans."""

from ao_bench import spans


def read(ctx):
    v = spans.view(ctx)
    return None if v is None else v.layer_ms_per_step("telemetry")
