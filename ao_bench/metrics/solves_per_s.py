"""solves_per_s: scenario control steps completed in the window (batch
times steps of every whole episode run) over the window's host-clock
seconds, which end with a device synchronize."""


def read(ctx):
    return ctx["solves"] / ctx["window_s"]
