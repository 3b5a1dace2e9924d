"""setup_s: host-clock seconds from the start of the run's process to the
start of the window: imports, the system's build (and on a first run in
a checkout the kernels' nvcc build) and the warm-up on the cell's
shapes."""


def read(ctx):
    return ctx["setup_s"]
