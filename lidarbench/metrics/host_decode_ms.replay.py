"""Mean ``host.decode`` a frame over the window's delivered frames
(``FrameMetrics.spans``, runtime/stream.py, runtime/pipeline.py
host_outputs_packed): the payload's copy, label unpacking and
dequantisation, in ms."""

from lidarbench.program import mean_span


def read(ctx):
    return mean_span(ctx, "host.decode")
