"""setup.build_s: host-clock seconds of the port's ``pipeline.build`` and
its warm-start command, ended by a device synchronize."""


def read(ctx):
    return ctx["build_s"]
