"""95th percentile latency of the live window's frames, from each frame's
publication on the program's schedule (``FrameMetrics.t_published``) to
its outputs in the harness's hands, on the harness's clock, in ms; a
dropped frame ranks by its time still pending at the loop's end
(``drive.latency_metrics``). Read in the traced run, over the frames
published after the profiler stopped."""

from lidarbench.drive import window_latency


def read(ctx):
    return window_latency(ctx, "latency_p95_ms")
