"""Mean ``FrameMetrics.t_host_ms`` over the window's delivered frames:
the host stage (payload decode, outlines through the native library,
vertex caps; runtime/pipeline.py::host_outputs_packed)."""


def read(ctx):
    v = [m.t_host_ms for m in ctx.frame_metrics]
    return sum(v) / len(v) if v else None
