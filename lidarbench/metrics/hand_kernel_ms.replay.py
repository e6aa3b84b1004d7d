"""Device time a frame of the hand-written kernels on the main path,
``tier_min_d2`` and ``union_find`` (kernels/tier_min_d2.py,
kernels/union_find.py), by kernel name in the traced sub-window."""

KERNELS = ("tier_min_d2", "union_find")


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.frames <= 0:
        return None
    s = tr.device_seconds(KERNELS)
    return s * 1e3 / tr.frames if s > 0 else None
