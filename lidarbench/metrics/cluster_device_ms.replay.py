"""Mean device ms a frame of the compiled step's clustering stage over the
window's delivered frames: ``FrameMetrics.device_ms["step.cluster"]``,
from the clock stamps inside the step's graph (kernels/stamp.py) before
``cluster_fused`` and before ``label_runs_presorted``."""

from lidarbench.program import mean_stage


def read(ctx):
    return mean_stage(ctx, "step.cluster")
