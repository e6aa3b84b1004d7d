"""The compiled step's device time a frame: summed device time of every
kernel, memcpy and memset in the traced sub-window over the frames
stepped in it (torch.profiler)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.frames <= 0:
        return None
    return tr.device_seconds() * 1e3 / tr.frames
