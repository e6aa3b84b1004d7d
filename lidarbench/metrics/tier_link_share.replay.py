"""The share of the pairs ``tier_min_d2`` tests whose verdict links, over
the window's delivered frames: the mean of
``FrameMetrics.counters["tier_links"]`` over the mean of
``counters["tier_pairs"]`` (ops/stixel.py, counted inside the step's
graph), in %."""

from lidarbench.program import mean_counter


def read(ctx):
    pairs = mean_counter(ctx, "tier_pairs")
    return (100.0 * mean_counter(ctx, "tier_links") / pairs if pairs
            else None)
