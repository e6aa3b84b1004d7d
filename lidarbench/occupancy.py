"""How full the step's capacities run, from the program's own counters.

The readers of ``metrics/*_share.replay.py`` call ``mean_share``: each
frame's count over the cap that bounds it, both counters of
``FrameMetrics.counters`` (lidar_processing_tpu_torch's
runtime/pipeline.py COUNTERS, counted inside the step's graph), in %,
averaged over the window's delivered frames. None where no frame carries
the pair: a program without those counters, or no frames.

Higher is better: the step runs every slot of a cap, filled or not, so a
share is the part of that padded work that is real, and a cap cut closer
to what the frames need raises it and takes work off each frame
(``frames_per_s``). The ceiling is the 1.2x headroom the caps are sized
with (83%); past the cap the step counts overflow and the run is not
correct.
"""

from __future__ import annotations

from typing import Optional


def mean_share(ctx, count: str, cap: str) -> Optional[float]:
    """Mean over the frames of 100 * counters[count] / counters[cap]."""
    pairs = [getattr(m, "counters", {}) for m in ctx.frame_metrics]
    shares = [100.0 * c[count] / c[cap] for c in pairs
              if c.get(cap) and count in c]
    return sum(shares) / len(shares) if shares else None
