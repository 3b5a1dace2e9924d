"""synthesis.ms_per_step: device time a step of the operations launched in
the program's ``synthesis`` span (the DM's modal phase of the last command
(u @ influence.T, its (B, R, R) synthesis GEMM) and the addcmul_ that
adds the turbulence): their summed durations in the traced episode over
its steps.  Nothing without the program's spans."""

from ao_bench import spans


def read(ctx):
    v = spans.view(ctx)
    return None if v is None else v.layer_ms_per_step("synthesis")
