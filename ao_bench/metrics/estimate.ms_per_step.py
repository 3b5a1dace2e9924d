"""estimate.ms_per_step: device time a step of the operations launched in
the program's ``estimate`` span (the LS or MMSE estimate, the Gauss-Newton
update and its phase synthesis, tracking and fusion): their summed
durations in the traced episode over its steps.  Nothing without the
program's spans."""

from ao_bench import spans


def read(ctx):
    v = spans.view(ctx)
    return None if v is None else v.layer_ms_per_step("estimate")
