"""Mean ``stream.dispatch`` a frame over the window's delivered frames
(``FrameMetrics.spans``, runtime/stream.py): the host's cost of launching
a step, the static-input copies, the graph replay, the payload's copy and
its event record, in µs."""

from lidarbench.program import mean_span


def read(ctx):
    return mean_span(ctx, "stream.dispatch", 1e6)
