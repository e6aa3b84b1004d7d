"""The general traffic driver: one loop for every traffic mix.

A mix is a data file (``lidarbench/traffic/<name>.json``); its ``loop``
picks how the window drives the program's served entry,
``ReplayStream.run``, host outlines always on (``with_outlines=True``):

- ``open``: the sensor publishes on a fixed schedule at ``rate_hz``
  whatever the consumer does (``run(realtime=True)``; a frame published
  while the window of ``queue_depth`` frames is full is dropped, as DDS
  keep-last does). Each frame's latency runs from its publication on the
  schedule to the moment its outputs reach this loop, on this loop's
  clock. The schedule is anchored when the loop first resumes ``run()``,
  which begins with one warm step before it starts its own clock: the
  latencies read long by at most that step.
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
from typing import Callable, Dict, List, NamedTuple, Optional

_FOREVER = 1 << 40


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
    late = [d.t - (anchor + d.seq * period) for d in got]
    # a dropped frame never comes: in the tail it counts as still
    # pending when the loop ended, later than any delivered frame
    tail = late + [end - (anchor + s * period)
                   for s in sorted(set(range(due)) - {d.seq for d in got})]
    metrics = {"latency_p50_ms": statistics.median(late) * 1e3 if late
               else float("nan"),
               "latency_p95_ms": percentile(tail, 95.0) * 1e3}
    return Window(got, due, due - len(got), due * period, metrics)


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
