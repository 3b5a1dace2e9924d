"""measure.b1_roofline: kernel B1's share of its roofline: the least
time of one call at the cell's shapes on the published H100 peaks
(``yardstick.measure_bound``: three TF32 passes of the DFT products)
over ``measure.b1_ms``."""


def read(ctx):
    ms = ctx["read"]("measure.b1_ms")
    if ms is None:
        return None
    est = ctx["config"]["estimator"]
    bound = ctx["yardstick"].measure_bound(
        "sym3", est["resolution"], ctx["traffic"]["batch"],
        2 * est["crop_half"] + 1, bf16=est["dft_dtype"] == "bfloat16")
    return 100.0 * bound["bound_ms"] / ms
