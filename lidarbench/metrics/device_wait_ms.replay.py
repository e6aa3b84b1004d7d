"""Mean ``stream.device_wait`` a frame over the window's delivered frames
(``FrameMetrics.spans``, runtime/stream.py): the host waiting on the
payload's event before the host stage, in ms."""

from lidarbench.program import mean_span


def read(ctx):
    return mean_span(ctx, "stream.device_wait")
