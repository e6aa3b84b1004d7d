"""Mean device ms a frame of the compiled step's payload stage over the
window's delivered frames: ``FrameMetrics.device_ms["step.pack"]``, from
the clock stamps inside the step's graph (kernels/stamp.py) before and
after ``pack_host_payload``."""

from lidarbench.program import mean_stage


def read(ctx):
    return mean_stage(ctx, "step.pack")
