"""Mean ``host.chi_hulls`` a frame over the window's delivered frames
(``FrameMetrics.spans``, runtime/pipeline.py _outlines_from_slices): the
native library's one ``chi_hulls_batch`` call of the frame, in ms."""

from lidarbench.program import mean_span


def read(ctx):
    return mean_span(ctx, "host.chi_hulls")
