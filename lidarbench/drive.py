"""The general traffic driver: one loop for every traffic mix.

A mix is a data file (``lidarbench/traffic/<name>.json``); its ``loop``
picks how the window drives the program's served entry,
``ReplayStream.run``, host outlines always on (``with_outlines=True``):

- ``open``: the sensor publishes on a fixed schedule at ``rate_hz``
  whatever the consumer does (``run(realtime=True)``; a frame published
  while the window of ``queue_depth`` frames is full is dropped, as DDS
  keep-last does). Each frame's latency runs from its publication,
  ``FrameMetrics.t_published``, to the moment its outputs reach this
  loop, on this loop's clock (``time.perf_counter``, the program's too).
  The program starts its schedule once ``run()`` has made its warm step,
  so the time before the first publication is no frame's latency; a
  node that runs for hours pays it once. The loop borrows that schedule
  and holds it to account: the first delivery gives its origin,
  ``t0 = t_published - seq / rate_hz``, and the run fails
  (``ScheduleError``) where the origin lies before the loop first
  resumed ``run()`` or more than ``MAX_OFFSET_PERIODS`` periods after
  it, where a delivery's ``seq`` is not the one the loop rebuilds or
  its ``t_published`` lies more than ``TOLERANCE_S`` off ``t0 + seq /
  rate_hz``, or where a frame's ``stream.dispatch`` span starts before
  its publication. A frame dropped from the window counts in the tail
  as still pending when the loop ended, from ``t0 + seq / rate_hz``.
  ``Window.schedule_offset_s`` is the origin less the loop's first
  resumption: the warm step, which the harness counts as set-up.
  ``Window.timeline`` keeps each due frame's publication, its latency
  and whether it was delivered; ``latency_metrics`` reduces it, over the
  whole window or the frames published from a given instant on: the
  median and 95th percentile latencies, and the share of the due frames
  whose outputs reached the loop within one period of their publication
  (a dropped frame never does).
- ``closed``: back to back (``run(realtime=False)``); the window opens
  at the first delivery and closes at the first delivery ``seconds``
  later; frames per second are the deliveries after the first over that
  time.

The outputs of a sample of the deliveries, ``keep(index)``, are kept for
the check; each is moved out of the cyclic garbage collector's reach as
it comes (``gc.freeze``), so keeping them adds no collection time to the
program's loop (left to the collector, hundreds of frames of outlines
made full collections of up to 0.7 s on the card's host). The others
are dropped as a consumer would drop them.

A delivery's sequence number is rebuilt from ``frame_id`` and
``frames_dropped``: the stream publishes its resident frames cyclically.
``hooks(index, t)`` is called after each delivery and each resumption
of ``run()`` runs inside ``resume()`` (the tracer's).
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

_FOREVER = 1 << 40
# The schedule's origin, at most this many periods after the loop first
# resumes run(): room for its one warm step (8.7-11.3 ms on an H100 at
# 10 Hz, 29 runs, against 50 ms), none for working out frames' outputs
# ahead of their publication (16 cycled sweeps are ~0.4 s of host work).
MAX_OFFSET_PERIODS = 0.5
TOLERANCE_S = 1e-6      # a publication, at most this off the schedule


class Delivery(NamedTuple):
    seq: int                  # publication sequence number
    t: float                  # when the outputs reached the loop (s)
    out: object               # FrameOutputs, None when not kept
    metrics: object           # FrameMetrics


class Window(NamedTuple):
    deliveries: List[Delivery]   # every delivery of the window's frames
    attempted: int
    failed: int
    seconds: float               # the window's length on the loop's clock
    metrics: Dict[str, float]    # end-to-end metrics
    # open loop: the program's schedule origin less the loop's first
    # resumption of run() (s); None for a closed loop
    schedule_offset_s: Optional[float] = None
    # open loop: (t_published, latency s, delivered) of each due frame in
    # publication order, a dropped frame's latency running to the loop's
    # end; the schedule's period (s)
    timeline: Optional[List[Tuple[float, float, bool]]] = None
    period: Optional[float] = None


class ScheduleError(RuntimeError):
    """The program's publications do not keep to one schedule."""


def _resumed(gen, resume):
    """The generator's items, each resumption inside ``resume()``."""
    while True:
        with resume():
            try:
                item = next(gen)
            except StopIteration:
                return
        yield item


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def _next_seq(prev: int, metrics, num_frames: int) -> int:
    seq = prev + 1 + int(metrics.frames_dropped)
    if int(metrics.frame_id) != seq % num_frames:
        raise RuntimeError(f"delivery of frame {metrics.frame_id} where the "
                           f"schedule has frame {seq % num_frames}")
    return seq


def _schedule_origin(got: List[Delivery], period: float,
                     anchor: float) -> float:
    """The origin of the program's publication schedule, from the first
    delivery; raises ScheduleError where the deliveries do not keep to
    it (see the module's docstring)."""
    if not got:
        raise ScheduleError("no frame of the window was delivered")
    t0 = got[0].metrics.t_published - got[0].seq * period
    if not anchor <= t0 <= anchor + MAX_OFFSET_PERIODS * period:
        raise ScheduleError(f"the schedule starts {(t0 - anchor) * 1e3:.3f} "
                            f"ms after the loop, not within [0, "
                            f"{MAX_OFFSET_PERIODS * period * 1e3:.0f}] ms")
    for d in got:
        m = d.metrics
        if int(m.seq) != d.seq:
            raise ScheduleError(f"delivery {d.seq} reports seq {m.seq}")
        off = m.t_published - (t0 + d.seq * period)
        if abs(off) > TOLERANCE_S:
            raise ScheduleError(f"frame {d.seq} published {off * 1e6:.3f} "
                                f"us off the schedule")
        start = next((s for name, s, _ in m.spans
                      if name == "stream.dispatch"), None)
        if start is None:
            raise ScheduleError(f"frame {d.seq} has no stream.dispatch span")
        if start < m.t_published:
            raise ScheduleError(f"frame {d.seq} dispatched "
                                f"{(m.t_published - start) * 1e6:.3f} us "
                                f"before its publication")
    return t0


def latency_metrics(timeline: List[Tuple[float, float, bool]],
                    period: float,
                    since: float = -math.inf) -> Optional[Dict[str, float]]:
    """The open loop's latencies over the frames of ``timeline`` published
    at or after ``since``: the median over the delivered frames, the 95th
    percentile over every frame (a dropped frame ranks by its time still
    pending), and the share of them delivered within one period of their
    publication, in %. None where no frame was delivered."""
    frames = [f for f in timeline if f[0] >= since]
    late = [s for _, s, delivered in frames if delivered]
    if not late:
        return None
    met = sum(1 for _, s, delivered in frames if delivered and s <= period)
    return {"latency_p50_ms": statistics.median(late) * 1e3,
            "latency_p95_ms": percentile([s for _, s, _ in frames],
                                         95.0) * 1e3,
            "deadline_met_share": 100.0 * met / len(frames)}


def window_latency(ctx, name: str) -> Optional[float]:
    """A per-layer reader's ``name`` of ``latency_metrics`` over the open
    loop's frames published from ``ctx.since`` on; None without an open
    loop's timeline."""
    w = ctx.window
    if w is None or w.timeline is None:
        return None
    got = latency_metrics(w.timeline, w.period, ctx.since)
    return None if got is None else got[name]


def _keep_all(index: int) -> bool:
    return True


def open_loop(stream, rate_hz: float, seconds: float,
              keep: Callable[[int], bool] = _keep_all,
              hooks: Optional[Callable] = None,
              resume: Callable = contextlib.nullcontext,
              clock: Callable[[], float] = time.perf_counter) -> Window:
    """Frames published in [0, seconds) on the schedule are the window's;
    the loop runs until the last of them is delivered or dropped."""
    period = 1.0 / rate_hz
    due = max(1, math.ceil(seconds * rate_hz))
    gen = stream.run(_FOREVER, realtime=True, with_outlines=True)
    anchor = clock()
    seq = -1
    got: List[Delivery] = []
    try:
        for out, m in _resumed(gen, resume):
            t = clock()
            seq = _next_seq(seq, m, stream.num_frames)
            if seq < due:
                got.append(Delivery(seq, t, out if keep(len(got)) else None,
                                    m))
                gc.freeze()
            if hooks is not None:
                hooks(len(got), t)
            if seq >= due - 1:
                break
    finally:
        gen.close()
    end = clock()
    t0 = _schedule_origin(got, period, anchor)
    timeline = [(d.metrics.t_published, d.t - d.metrics.t_published, True)
                for d in got]
    # a dropped frame never comes: in the tail it counts as still
    # pending when the loop ended, later than any delivered frame
    timeline += [(t0 + s * period, end - (t0 + s * period), False)
                 for s in set(range(due)) - {d.seq for d in got}]
    timeline.sort()
    return Window(got, due, due - len(got), due * period,
                  latency_metrics(timeline, period), t0 - anchor,
                  timeline, period)


def closed_loop(stream, seconds: float,
                keep: Callable[[int], bool] = _keep_all,
                hooks: Optional[Callable] = None,
                resume: Callable = contextlib.nullcontext,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    gen = stream.run(_FOREVER, realtime=False, with_outlines=True)
    got: List[Delivery] = []
    seq = -1
    try:
        for out, m in _resumed(gen, resume):
            t = clock()
            seq = _next_seq(seq, m, stream.num_frames)
            got.append(Delivery(seq, t, out if keep(len(got)) else None, m))
            gc.freeze()
            if hooks is not None:
                hooks(len(got), t)
            if t - got[0].t >= seconds and len(got) > 1:
                break
    finally:
        gen.close()
    span = got[-1].t - got[0].t
    return Window(got, len(got), 0, span,
                  {"frames_per_s": (len(got) - 1) / span})


def drive(stream, traffic: Dict, seconds: float,
          keep: Callable[[int], bool] = _keep_all,
          hooks: Optional[Callable] = None,
          resume: Callable = contextlib.nullcontext,
          clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run the window the traffic file describes."""
    loop = traffic["loop"]
    try:
        if loop == "open":
            return open_loop(stream, traffic["rate_hz"], seconds, keep,
                             hooks, resume, clock)
        if loop == "closed":
            return closed_loop(stream, seconds, keep, hooks, resume, clock)
    finally:
        gc.unfreeze()
    raise ValueError(f"unknown loop {loop!r}: 'open' or 'closed'")
