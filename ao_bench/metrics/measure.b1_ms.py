"""measure.b1_ms: kernel B1's device time a call in the traced episode:
the summed durations of its kernels (the operator image and the measure
kernel) over the calls its wrapper counted in the same episode.  Nothing
when the episode ran no B1 kernel."""

KERNELS = ("psf_div3_sym_kernel", "operator_image_tf32")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    calls = tr.counters.get("b1_launches", 0)
    _, main = tr.kernel_seconds(lambda n: KERNELS[0] in n)
    if not calls or not main:
        return None
    seconds, _ = tr.kernel_seconds(lambda n: any(k in n for k in KERNELS))
    return 1e3 * seconds / calls
