"""How full the step's obstacle buffer runs: each frame's obstacle points
before the buffer's clamp over its slots (``max_obstacle_points``),
``FrameMetrics.counters["obstacle_points"]`` over
``counters["obstacle_slots"]`` (ops/stixel.py), in %, the mean over the
window's delivered frames."""

from lidarbench.occupancy import mean_share


def read(ctx):
    return mean_share(ctx, "obstacle_points", "obstacle_slots")
