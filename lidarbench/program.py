"""Means of the program's own per-frame record over a window.

The per-layer readers of ``metrics/`` that read ``FrameMetrics``'s
``spans``, ``device_ms`` and ``counters`` (lidar_processing_tpu_torch's
runtime/stream.py) call these. Each is the mean over the window's
delivered frames that carry the field, and None where no frame does: a
program without the field, or no frames.
"""

from __future__ import annotations

from typing import Optional


def _mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def mean_span(ctx, name: str, scale: float = 1e3) -> Optional[float]:
    """Mean seconds a frame of the spans named `name` (summed where a
    frame has several), times `scale` (1e3: ms)."""
    def total(m):
        spans = [e - s for n, s, e in getattr(m, "spans", ()) if n == name]
        return sum(spans) * scale if spans else None
    return _mean(v for v in map(total, ctx.frame_metrics) if v is not None)


def mean_stage(ctx, stage: str) -> Optional[float]:
    """Mean device ms a frame of the step's stage `stage`."""
    return _mean(m.device_ms[stage] for m in ctx.frame_metrics
                 if stage in getattr(m, "device_ms", {}))


def mean_counter(ctx, name: str) -> Optional[float]:
    """Mean a frame of the step's work counter `name`."""
    return _mean(m.counters[name] for m in ctx.frame_metrics
                 if name in getattr(m, "counters", {}))
