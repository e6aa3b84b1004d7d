"""Share of the window's delivered frames that the stream consumed
because the next publication was not yet due
(``FrameMetrics.consumed_early``, runtime/stream.py), rather than when
the depth-``queue_depth`` window was full or at the end-of-run drain, in
%; over the frames that carry the field, None where none does."""


def read(ctx):
    v = [m.consumed_early for m in ctx.frame_metrics
         if hasattr(m, "consumed_early")]
    return 100.0 * sum(v) / len(v) if v else None
