"""measure.ms_per_step: device time a step of the operations launched in
the program's ``measure`` span (the noise draw and every call of
estimator.measure (B1 and its small ops), the Gauss-Newton and tracking
estimators' too): their summed durations in the traced episode over its
steps.  Nothing without the program's spans."""

from ao_bench import spans


def read(ctx):
    v = spans.view(ctx)
    return None if v is None else v.layer_ms_per_step("measure")
