"""Host spans of a frame's life, on ``time.perf_counter``.

A frame's ``Spans`` is a chain of named spans that share their bounds:
``begin(name)`` ends the open span and opens `name` at one clock read,
``end()`` ends it, and each ended span is appended to ``record`` as
``(name, start, end)``, seconds on ``time.perf_counter``. So the spans
of one chain tile the time from its first ``begin`` to its ``end`` with
no gap, and every line of code in between is some span's. While
torch.profiler records, each span also runs inside
``torch.profiler.record_function(name)``, so it lands in the profiler's
trace on the profiler's clock; otherwise no profiler call is made (a
record_function costs ~7 µs, the check ~0.03 µs). A name may recur in a
record: its spans add up (``total_ms``). No span stays open across a
``yield``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

Span = Tuple[str, float, float]


class Spans:
    """One chain of spans and the record it appends to (a list, shared
    by the chains of one frame)."""

    __slots__ = ("record", "_name", "_start", "_range")

    def __init__(self, record: Optional[List[Span]] = None):
        self.record: List[Span] = [] if record is None else record
        self._name: Optional[str] = None
        self._range = None

    def begin(self, name: str) -> float:
        """End the open span, if any, and open `name` at the same clock
        read, which is returned; where `name` is open, it runs on."""
        now = time.perf_counter()
        if name == self._name:
            return now
        self._close(now)
        self._name, self._start = name, now
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(name)
            self._range.__enter__()
        return now

    def end(self) -> float:
        """End the open span; the clock read that ended it."""
        now = time.perf_counter()
        self._close(now)
        return now

    def _close(self, now: float) -> None:
        if self._name is not None:
            self.record.append((self._name, self._start, now))
            self._name = None
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


def begin(spans: Optional[Spans], name: str) -> None:
    """``spans.begin(name)``, where there is a chain."""
    if spans is not None:
        spans.begin(name)


def total_ms(record: List[Span], name: str) -> Optional[float]:
    """The summed milliseconds of the spans named `name` in `record`,
    None when it has none."""
    ms = [(e - s) * 1e3 for n, s, e in record if n == name]
    return sum(ms) if ms else None
