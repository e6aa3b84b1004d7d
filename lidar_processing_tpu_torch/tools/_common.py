"""Device choice and timing shared by the port's tool entry points."""

from __future__ import annotations

import time

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; never a silent CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this entry point runs on a CUDA GPU and none "
                           "is available; pass device='cpu' to run the "
                           "plain twins on the CPU")
    return dev


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Mean ms of fn() over `reps` runs after one warmup: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def clock(device: torch.device) -> str:
    return "CUDA events" if device.type == "cuda" else "host clock, CPU"
