"""setup.nvcc_builds: nvcc runs in the run's process (the program's
``ops.cuda_build.compiles``): 0 when every kernel library came from the
checkout's build cache, one a library built anew.  Nothing without a
device trace (a CPU run builds no kernel) or without the counter."""

import sys


def read(ctx):
    tr = ctx["trace"]
    build = sys.modules.get("mpc_sensorlessao_tpu_torch.ops.cuda_build")
    if tr is None or not tr.device:
        return None
    return getattr(build, "compiles", None)
