"""How full the outline slots run: each frame's clusters that need the
kind of outline slot they fill the more (small: device convex hulls,
large: host outlines) over that kind's slots (the step's ``SMALL_C`` /
``large_cluster_slots``), ``FrameMetrics.counters["outline_clusters"]``
over ``counters["outline_slots"]`` (runtime/pipeline.py), in %, the mean
over the window's delivered frames."""

from lidarbench.occupancy import mean_share


def read(ctx):
    return mean_share(ctx, "outline_clusters", "outline_slots")
