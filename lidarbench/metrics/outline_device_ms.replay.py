"""Mean device ms a frame of the compiled step's outline stage (label runs
and the hull stage) over the window's delivered frames:
``FrameMetrics.device_ms["step.outline"]``, from the clock stamps inside
the step's graph (kernels/stamp.py) before ``label_runs_presorted`` and
before ``pack_host_payload``."""

from lidarbench.program import mean_stage


def read(ctx):
    return mean_stage(ctx, "step.outline")
