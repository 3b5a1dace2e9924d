"""settled_strehl: the mean exact (OTF-volume) Strehl over the last half
of every episode of the window and every scenario the divergence rule
keeps (``StepOutputs.strehl_exact``)."""


def read(ctx):
    return ctx["settled_strehl"]
