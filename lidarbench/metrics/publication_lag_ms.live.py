"""Mean publication lag a frame over the window's delivered frames: its
dispatch start (``stream.dispatch`` in ``FrameMetrics.spans``) less its
publication time on the sensor's schedule (``FrameMetrics.t_published``,
runtime/stream.py), in ms."""


def read(ctx):
    v = []
    for m in ctx.frame_metrics:
        starts = [s for n, s, _ in getattr(m, "spans", ())
                  if n == "stream.dispatch"]
        if starts:
            v.append((starts[0] - m.t_published) * 1e3)
    return sum(v) / len(v) if v else None
