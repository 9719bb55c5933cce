"""Share (%) of the traced catalogs' wall time in which no operation ran
on the card: one minus the union of the device operations' intervals
over the traced window.  Nothing where no device operation was traced
(a run on the CPU)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s() <= 0 or not tr.names:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
