"""The traced run's device trace: torch.profiler over a steady sub-window.

The profiler starts after delivery ``skip`` of the window; the next
delivery's frame is its warm-up (a profile loses its first kernel events
without one) and the sub-window runs from that delivery to the one
``frames`` deliveries later, marked by a ``lidarbench.window`` span.
Between two deliveries the stream dispatches exactly as many frames as
it delivers, so the sub-window steps ``frames`` frames. The trace is
read from torch.profiler's Chrome trace: device activity is every
kernel, memcpy and memset event; host activity the CPU-side events
(operators, CUDA runtime calls, this harness's spans).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW_SPAN = "lidarbench.window"
RESUME_SPAN = "lidarbench.resume_run"


class Trace(NamedTuple):
    window_us: Tuple[float, float]          # the sub-window on the trace clock
    frames: int                             # frames stepped in it
    device: List[Tuple[str, float, float]]  # (name, start, end) in µs, clipped
    host: List[Tuple[str, float, float]]    # (name, start, end) in µs

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def idle_gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window_us
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def device_seconds(self, match=None) -> float:
        """Summed device time of the operations whose name contains one
        of ``match`` (all operations when None)."""
        return sum(e - s for n, s, e in self.device
                   if match is None or any(m in n for m in match)) * 1e-6

    def host_at(self, t: float) -> str:
        """The innermost host span around time t."""
        best = None
        for n, s, e in self.host:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (n, e - s)
        return best[0] if best else "no host span"

    def breakdown(self) -> Dict[str, list]:
        ops: Dict[str, float] = {}
        for n, s, e in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s) * 1e-6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, v] for n, v in top],
                "idle_gaps": [[self.host_at((s + e) / 2), (e - s) * 1e-6]
                              for s, e in gaps]}


def parse(events: List[dict], frames: int) -> Optional[Trace]:
    """The sub-window's Trace from Chrome trace events; None when the
    window span is missing."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("ph") == "X"]
    if not spans:
        return None
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            if t > lo and s < hi:
                device.append((e.get("name", "?"), max(s, lo), min(t, hi)))
        elif cat in HOST_CATS and t > lo and s < hi:
            host.append((e.get("name", "?"), s, t))
    return Trace((lo, hi), frames, device, host)


class Tracer:
    """Drives torch.profiler from the window's delivery hook; ``resume``
    is the span around each resumption of ``run()``."""

    def __init__(self, skip: int, frames: int):
        self.skip, self.frames = skip, frames
        self.prof = None
        self.span = None
        self.done = False
        self.trace: Optional[Trace] = None

    def prime(self, device) -> None:
        """One profiled step of nothing much, in set-up: the profiler's
        first start (loading and starting CUPTI) takes seconds, which
        would otherwise fall inside the window."""
        import torch
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def resume(self):
        import torch
        return torch.profiler.record_function(RESUME_SPAN)

    def __call__(self, index: int, _t: float) -> None:
        import torch
        if index == self.skip and self.prof is None:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
        elif index == self.skip + 1 and self.prof is not None:
            self.span = torch.profiler.record_function(WINDOW_SPAN)
            self.span.__enter__()
        elif index == self.skip + 1 + self.frames and self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None
            self.done = True
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()

    def finish(self) -> Optional[Trace]:
        """After the window: stop the profiler if the window ended first
        (no trace then), else read the sub-window's trace."""
        if self.prof is None:
            return None
        if not self.done:
            if self.span is not None:
                self.span.__exit__(None, None, None)
            self.prof.stop()
            self.prof = None
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        self.trace = parse(events, self.frames)
        return self.trace
