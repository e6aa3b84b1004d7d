"""Clock stamps inside the step: the card's %globaltimer into a stats row.

Replaces no TPU kernel. The JAX package times its stages from the host
(its stream's stage-timed replay, standalone stages each waited for);
the port's step is one CUDA graph, so a host clock sees only its ends.
``stamp(stats, slot)`` captured between two stages writes the time at
which the device reached that boundary, on every replay, into column
`slot` of each row of the int64 (B, K) tensor `stats`: on a CUDA tensor
one thread of ``csrc/union_find.cu``'s ``globaltimer_stamp_kernel``
(nanoseconds of the card's clock; 8 bytes a row, bound by its launch);
on a CPU tensor the twin writes ``time.perf_counter_ns()``, which is when
the CPU, running each op as it is called, reaches the boundary. Stream
order puts a stamp after every operation enqueued before it.
"""

from __future__ import annotations

import time

import torch

from . import _build


def stamp(stats: torch.Tensor, slot: int) -> None:
    """Write the device's clock (ns) into ``stats[:, slot]``; stats is a
    contiguous int64 (B, K) tensor. A CUDA tensor launches the kernel
    (counted in ``stamp.launches``), a CPU tensor runs the twin."""
    if not 0 <= slot < stats.shape[-1]:
        raise ValueError(f"stamp: slot {slot} outside a row of "
                         f"{stats.shape[-1]}")
    if not stats.is_cuda:
        stats[:, slot] = time.perf_counter_ns()
        return
    dev = _build.checked("stamp", ("stats", stats, torch.int64, 2))
    _build.launch(stamp, "globaltimer_stamp_launch", dev,
                  stats.data_ptr() + slot * stats.element_size(),
                  stats.stride(0), stats.shape[0])


stamp.launches = 0
