"""Median latency of the live window's delivered frames, from each
frame's publication on the program's schedule (``FrameMetrics.t_published``)
to its outputs in the harness's hands, on the harness's clock, in ms
(``drive.latency_metrics``). Read in the traced run, over the frames
published after the profiler stopped, so that the profiled sub-window's
host overhead and the frames dropped while it starts are not in it."""

from lidarbench.drive import window_latency


def read(ctx):
    return window_latency(ctx, "latency_p50_ms")
