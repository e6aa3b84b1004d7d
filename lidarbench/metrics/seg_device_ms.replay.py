"""Mean device ms a frame of the compiled step's segmentation stage over the
window's delivered frames: ``FrameMetrics.device_ms["step.segment"]``,
from the clock stamps inside the step's graph (kernels/stamp.py) before
``gpf_segment_sorted`` and before ``cluster_fused``."""

from lidarbench.program import mean_stage


def read(ctx):
    return mean_stage(ctx, "step.segment")
