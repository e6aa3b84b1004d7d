"""Mean ``FrameMetrics.t_dispatch_ms`` over the window's delivered frames:
the runtime's span from a frame's dispatch to its consumption, the
depth-``queue_depth`` window's hold included (runtime/stream.py)."""


def read(ctx):
    v = [m.t_dispatch_ms for m in ctx.frame_metrics]
    return sum(v) / len(v) if v else None
