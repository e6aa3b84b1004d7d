"""The card's idle share of the traced sub-window: 1 - the union of its
device activity intervals over the sub-window's wall time, in %."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
