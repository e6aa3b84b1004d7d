"""One run of one cell: set-up, the measured window, the check.

Set-up (``setup_s``, from process start): the cell's resident frames
are made from the seed by the benchmark's scene generator and written as
PCD files into a fresh directory under ``TMPDIR``; ``ReplayStream``
loads them onto the device, ``warmup()`` captures the compiled step, and
one pre-roll of ``queue_depth + 1`` frames through ``run()`` builds the
native host stage and the stream's pinned payload buffers, so nothing
builds inside the window; in an open loop set-up ends at the program's
first publication, after ``run()``'s own warm step. The window drives
``ReplayStream.run`` as the cell's traffic file says (``drive.py``);
with tracing on, torch.profiler records a steady sub-window
(``trace.py``), and the per-layer readers get the window itself beside
it. After the window the peak
memory is read, the stream's graph is freed, and the deliveries are
judged against the plain reference (``check.py``): a sample drawn from the
seed, every resident frame among it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from . import check, drive, scenes
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_processing_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class ForbiddenImport(RuntimeError):
    pass


def assert_no_jax(where: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"{where}: loaded {', '.join(found)}")


def make_frames(config: Dict, seed: int, count: int):
    """The run's resident frames: [(xyz, intensity)] from the seed."""
    return scenes.resident_frames(config, seed, count)


def check_sample(seed: int, resident: int):
    """Which deliveries the check judges: the first ``resident`` (every
    resident frame once), then each with chance 1/``resident``, drawn
    from the seed."""
    draws = np.random.default_rng(np.random.SeedSequence(
        [abs(int(seed)), 1])).random(1 << 16)

    def keep(index: int) -> bool:
        return index < resident or draws[index % draws.size] < 1.0 / resident
    return keep


def engine_config(config: Dict, traffic: Dict):
    """DEFAULT_CONFIG with the configuration's overrides, then the
    traffic's rate (open loops) and window depth."""
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    groups = {g: dataclasses.replace(getattr(DEFAULT_CONFIG, g), **fields)
              for g, fields in config["engine"].items()}
    cfg = DEFAULT_CONFIG.replace(**groups)
    pipe = {"queue_depth": traffic["queue_depth"]}
    if traffic["loop"] == "open":
        pipe["replay_rate_hz"] = float(traffic["rate_hz"])
    return cfg.replace(pipeline=dataclasses.replace(cfg.pipeline, **pipe))


class Context(NamedTuple):
    """What a per-layer metric's reader reads."""

    frame_metrics: list         # FrameMetrics of the window's deliveries
    trace: Optional[object]     # trace.Trace of the sub-window, or None
    window: Optional[object] = None   # drive.Window
    # readers of the window's latencies take the frames published from
    # here on (time.perf_counter s): after the profiler stopped
    since: float = -math.inf


class Result(NamedTuple):
    line: Dict                  # the result line's object
    check_lines: List[str]
    setup_phases: Dict[str, float]   # seconds of each step of set-up


def run_cell(spec, workload: str, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda",
             config: Optional[Dict] = None, traffic: Optional[Dict] = None,
             limits: Optional[Dict] = None, chips: int = 1,
             stream_hook=None) -> Result:
    """One run of the cell. ``config``, ``traffic`` and ``limits`` default
    to the cell's files; ``stream_hook(stream)`` may wrap the built
    stream (the tests' planted faults)."""
    import torch
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream

    cell = spec.workload(workload)
    config = config or spec.config(cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    limits = limits or spec.limits(cell["config"])
    ecfg = engine_config(config, traffic)
    phases = {"start": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    frames = make_frames(config, seed, traffic["resident_frames"])
    phase("frames")
    tmp = tempfile.mkdtemp(prefix="lidarbench-frames-")
    try:
        for i, (xyz, inten) in enumerate(frames):
            scenes.write_pcd(os.path.join(tmp, f"{i:06d}.pcd"), xyz, inten)
        stream = ReplayStream(ecfg, data_dir=tmp, device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("load")
    stream.warmup()
    phase("warmup")
    for _ in stream.run(ecfg.pipeline.queue_depth + 1, realtime=False,
                        with_outlines=True):
        pass
    stream.sync()
    phase("preroll")
    if stream_hook is not None:
        stream = stream_hook(stream)
    tracer = Tracer(traffic["trace"]["skip_frames"],
                    traffic["trace"]["frames"]) if traced else None
    if tracer is not None:
        tracer.prime(device)
        phase("profiler")
    assert_no_jax("after set-up")
    setup_s = time.perf_counter() - t_start

    window = drive.drive(stream, traffic, seconds,
                         keep=check_sample(seed, traffic["resident_frames"]),
                         hooks=tracer, resume=tracer.resume if tracer
                         else contextlib.nullcontext)
    stream.sync()
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    assert_no_jax("after the window")
    tr = tracer.finish() if tracer else None
    stream.release()
    del stream
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    verdict = check.judge([f[0] for f in frames],
                          [(d.metrics.frame_id, d.out)
                           for d in window.deliveries if d.out is not None],
                          dataclasses.asdict(ecfg), limits, device)

    metrics: Dict[str, Dict] = {}
    if window.schedule_offset_s is not None:
        # set-up ends at the program's first publication: run()'s warm
        # step is set-up, and no frame's latency counts it
        setup_s += window.schedule_offset_s
    if not traced:
        values = dict(window.metrics, setup_s=setup_s)
        for m in spec.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = Context([d.metrics for d in window.deliveries], tr, window,
                      tracer.t_stopped)
        for m in spec.per_layer(workload):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = tr.busy_s() if tr else 0.0
        dev["window_s"] = tr.window_s if tr else 0.0
    line = {"correct": verdict.correct, "attempted": window.attempted,
            "failed": window.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        line["breakdown"] = tr.breakdown()
    if window.schedule_offset_s is not None:
        # not metrics of their own: the warm step, inside setup_s, and
        # the latencies over every frame of the window (per-layer metrics
        # of traced runs, read after the profiler stopped)
        line["schedule_offset_ms"] = window.schedule_offset_s * 1e3
        line["latency_ms"] = {
            "p50": window.metrics["latency_p50_ms"],
            "p95": window.metrics["latency_p95_ms"]}
    line["checks"] = {k: {"value": verdict.numbers[k],
                          "limit": verdict.limits[k]}
                      for k in check.NUMBERS}
    return Result(line, check.report_lines(verdict), phases)
