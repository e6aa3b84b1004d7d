"""Mean ``stream.hold`` a frame over the window's delivered frames
(``FrameMetrics.spans``, runtime/stream.py): the step's last device
stamp, mapped to the host clock, to the start of the frame's
consumption: how long its ready outputs sat in the depth-``queue_depth``
window, in ms."""

from lidarbench.program import mean_span


def read(ctx):
    return mean_span(ctx, "stream.hold")
