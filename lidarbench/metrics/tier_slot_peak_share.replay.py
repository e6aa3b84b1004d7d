"""How full the exact tests' fullest tier runs: each frame's pairs in the
tier of either tier table that they fill the most, over that tier's slots
(``intra_tier_slots`` / the step's supernode-pair table),
``FrameMetrics.counters["tier_peak_pairs"]`` over
``counters["tier_peak_slots"]`` (ops/stixel.py), in %, the mean over the
window's delivered frames."""

from lidarbench.occupancy import mean_share


def read(ctx):
    return mean_share(ctx, "tier_peak_pairs", "tier_peak_slots")
