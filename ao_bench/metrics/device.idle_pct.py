"""device.idle_pct: the share of the traced episode in which no kernel,
copy or fill ran on the card: one minus the union of their intervals
over the episode's host-clock length.  The episode is traced with the
device activity alone, so the profiler does not slow the host that
feeds the card."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
