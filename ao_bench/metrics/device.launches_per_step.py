"""device.launches_per_step: kernels launched in the traced episode over
its closed-loop steps (a count: it repeats exactly)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.steps
