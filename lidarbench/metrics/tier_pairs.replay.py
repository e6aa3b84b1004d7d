"""Mean pairs a frame that ``tier_min_d2`` tests, over the window's
delivered frames: ``FrameMetrics.counters["tier_pairs"]``, the tier
tables' pair counts of both ``_tiered_exact`` calls (ops/stixel.py),
counted inside the step's graph."""

from lidarbench.program import mean_counter


def read(ctx):
    return mean_counter(ctx, "tier_pairs")
