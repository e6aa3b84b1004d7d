"""Mean ``host.caps`` a frame over the window's delivered frames
(``FrameMetrics.spans``, runtime/pipeline.py): the vertex caps,
``simplify_ring`` over the frame's outlines, in ms."""

from lidarbench.program import mean_span


def read(ctx):
    return mean_span(ctx, "host.caps")
