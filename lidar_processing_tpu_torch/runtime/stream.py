"""Streaming replay runtime: the dataloader/processor node pair, on a GPU.

Port of ``lidar_processing_tpu/runtime/stream.py``. The reference runs a
dataloader that preloads all frames and republishes them cyclically at
10 Hz over DDS, and a processor that runs the pipeline in the subscriber
callback (ref: src/dataloader.cpp:128-175, src/processor.cpp:135-268), with
keep-last-2 QoS (ref: src/processor.cpp:69-85). Here the frames are
preloaded into device memory once and the replay loop indexes into the
resident buffer, so the steady state has no host->device traffic.

On the card each step is the compiled step (runtime/compiled.py): the
packed step captured once as a CUDA graph in ``warmup()`` and replayed, as
the JAX stream jits its ``_step``; ``eager=True`` asks for the eager
step, which the CPU always runs. Each frame's packed payload
(runtime/pipeline.py) is copied into a pinned host buffer with
``non_blocking=True`` on the step's stream, and a CUDA event marks when it
has landed; the copy is enqueued before the next step, so stream order
keeps it from the replay that overwrites the graph's static output.
Back to back, at most ``queue_depth`` frames are in flight, and the host
decodes the oldest while the device runs the next. Realtime mode
publishes on a clock and keeps the DDS depth-``queue_depth`` semantics: a
frame is consumed as soon as the next publication leaves time, as the
reference computes each sweep in its subscriber callback, and the window
bounds the frames in flight only when the consumer falls behind, which
then sees dropped frames, not growing lag. On a CPU device the payload
is cloned on the host and no event is used.
Per-stage metrics mirror the reference's timing logs
(ref: src/processor.cpp:167-171,204-207,218-219).

Each frame's ``FrameMetrics`` carries its life from publication to
outputs, always recorded: host spans (runtime/spans.py, exported to
torch.profiler while it records) and the step's stats row, copied beside
the payload before the same event. The step is
``device_frame_step_stamped_batched``: five device clock stamps inside it
give each frame's device time a stage (``device_ms``), and the stixel
backend's work counters ride along (``counters``). The stamps are mapped
onto ``time.perf_counter`` by an offset that ``warmup()`` calibrates, a
stamp bracketed by two host reads, the tightest of CALIBRATION_TRIES,
and ``run()`` calibrates again every RECALIBRATE_S seconds, so that the
spans built from them (``stream.queue``, the ``step.*`` stages,
``stream.hold``) lie on the host's clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..io.dataset import list_frames, preload_padded
from ..kernels.stamp import stamp
from ..ops import stixel as _stixel
from ..ops.segmentation import gpf_segment
from ..types import SEG_OBSTACLE
from . import compiled
from .pipeline import (COUNTERS, STAGES, device_frame_step_stamped_batched,
                       host_outputs_packed)
from .spans import Span, Spans

CALIBRATION_TRIES = 20   # bracketed stamps a calibration keeps the best of
# run()'s seconds between two calibrations: the card's clock drifts from
# the host's by ~4.7 µs a second (H100 80GB HBM3), ~23 µs in that time
RECALIBRATE_S = 5.0


def segment_stage(xyzs: torch.Tensor, masks: torch.Tensor,
                  config: EngineConfig):
    """The stage-timed replay's segmentation stage, (B, N) frames: their
    SegmentationResult and obstacle mask (the JAX stream's ``_seg``)."""
    seg = gpf_segment(xyzs, masks, config.segmentation)
    return seg, masks & (seg.labels == SEG_OBSTACLE)


def cluster_stage(xyzs: torch.Tensor, obstacle: torch.Tensor,
                  config: EngineConfig):
    """The stage-timed replay's clustering stage: ``stixel.cluster`` of
    the obstacle masks (the JAX stream's ``_cluster``)."""
    return _stixel.cluster(xyzs, obstacle, config.clustering,
                           config.pipeline)


@dataclasses.dataclass
class FrameMetrics:
    """Per-frame observability record (ref: processor.cpp logging)."""

    frame_id: int
    # dispatch to consumption: the step's launch, its queue and device
    # time, and the hold in the window (``spans`` splits it); in realtime
    # mode a frame is consumed as soon as the next publication leaves
    # time, so it is held only where the consumer fell behind
    t_dispatch_ms: float
    t_host_ms: float          # host stage: payload decode, outlines, caps
    ground_points: int
    obstacle_points: int
    num_clusters: int
    num_outlines: int
    overflow: int
    # publication to outputs (t_published to the end of the host stage)
    # took longer than the replay period
    deadline_missed: bool
    # frames dropped immediately before this one because the in-flight
    # window was full when they were published (realtime mode only —
    # DDS QoS keep-last-`queue_depth`, ref: src/processor.cpp:69-73)
    frames_dropped: int = 0
    # per-stage times (stage_timing=True only; mirrors the reference's
    # separate seg/cluster/polygonize logs, ref: src/processor.cpp:167-168,
    # 204-205,218-219). TRIAGE-GRADE: seg and cluster are standalone
    # stages (``segment_stage``, ``cluster_stage``) on the stream's route,
    # each waited for: on the card two B = 1 graphs replayed, as the step
    # is, so the three times are all compiled ones; t_hull is the fused
    # step's residual after subtracting them, so the split differs from
    # the fused step's true internals (which share sorts across stages);
    # for optimization use the device traces (torch.profiler,
    # tools/step_bench.py).
    t_seg_ms: Optional[float] = None
    t_cluster_ms: Optional[float] = None
    t_hull_ms: Optional[float] = None
    # publication sequence number (frames published cyclically from 0)
    # and its publication time (time.perf_counter s): on the schedule in
    # realtime mode, the dispatch start otherwise
    seq: int = 0
    t_published: float = 0.0
    # (name, start, end) on time.perf_counter s, in order from
    # publication: [stream.publication_wait,] stream.lag, stream.dispatch,
    # stream.queue (from the dispatch's start to the first device stamp),
    # the step.* stages (device stamps mapped to the host clock),
    # stream.hold (ready outputs left in the window: empty in realtime
    # mode unless the consumer fell behind, back to back until
    # `queue_depth` newer frames are in flight), stream.device_wait,
    # host.decode, host.assemble, host.chi_hulls, host.caps,
    # host.assemble, host.counts (decode, chi_hulls, caps and assemble
    # make t_host_ms)
    spans: List[Span] = dataclasses.field(default_factory=list)
    # the step's stages, device ms from its stamps
    device_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the step's work counts (stixel backend): pipeline.COUNTERS
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    # consumed because the next publication was not yet due (realtime
    # mode); False where the full window or the end-of-run drain took it
    consumed_early: bool = False


class ReplayStream:
    """Device-resident cyclic frame replayer with a bounded in-flight window.

    Runs on the card (``device=None`` means ``cuda``, and raises where
    there is none); the CPU only when the caller passes ``device="cpu"``.
    The step is ``compiled.batched_step``'s: the compiled step on the card
    unless ``eager``, the eager step on the CPU.

    Usage:
        stream = ReplayStream(config, data_dir)
        for out, metrics in stream.run(num_frames=154):
            ...
    """

    def __init__(self, config: EngineConfig,
                 data_dir: Optional[str] = None,
                 device: Optional[torch.device] = None,
                 eager: bool = False):
        self.config = config
        # the card unless the caller names a device: no silent CPU fallback
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ReplayStream: no CUDA GPU is available; "
                               "pass device='cpu' to replay on the CPU")
        paths = list_frames(data_dir) if data_dir else list_frames()
        xyz, inten, counts = preload_padded(paths, config.pipeline.max_points)
        # intensity rides along on the host for output passthrough
        # (ref: src/dataloader.cpp:106-110 schema carries intensity)
        self.intensity = inten
        # whole sequence resident in device memory
        self.xyz = torch.from_numpy(xyz).to(self.device)
        mask = np.arange(xyz.shape[1])[None, :] < counts[:, None]
        self.mask = torch.from_numpy(mask).to(self.device)
        self.counts = counts
        self.num_frames = xyz.shape[0]
        # pinned (payload, stats) ring slots
        self._pinned: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.eager = eager
        self._stepper = None      # the B = 1 step, built by the first step
        self._stages = None       # the stage-timed replay's two stages
        # the stamps' clock: host ns = stamp - offset, within the error
        self.clock_offset_ns = 0
        self.clock_error_ns: Optional[int] = None   # None: not calibrated
        self._calibrated_at = 0.0
        self._clock = None        # (device stamp row, host copy, stream)

    def _step(self, fid: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frame fid's (payload, stats row), the compiled step's static
        outputs on the card: the next step overwrites them."""
        if self._stepper is None:
            self._stepper = compiled.batched_step(
                device_frame_step_stamped_batched, self.config, 1,
                self.device, self.eager)
        payload, stats = self._stepper(self.xyz[fid:fid + 1],
                                       self.mask[fid:fid + 1])
        return payload[0], stats[0]

    @property
    def graph(self) -> Optional[compiled.CompiledStep]:
        """The compiled step the stream replays (None before the first
        step and on the eager route)."""
        return (self._stepper
                if isinstance(self._stepper, compiled.CompiledStep) else None)

    @property
    def stage_graphs(self) -> tuple:
        """The stage-timed replay's compiled stages (segmentation,
        clustering), () before the first stage-timed step and on the
        eager route."""
        return tuple(s for s in self._stages or ()
                     if isinstance(s, compiled.CompiledStep))

    def release(self) -> None:
        """Free the compiled step's graph and the stages'; the next step
        captures them again."""
        for graph in (self.graph, *self.stage_graphs):
            if graph is not None:
                graph.release()
        self._stepper = self._stages = None

    def sync(self) -> None:
        """Wait for the work queued on the stream's device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """One step end to end: builds the kernels, warms the caches and,
        the first time on the compiled route, captures the step; then
        calibrates the stamps' clock."""
        self._step(0)
        self.sync()
        self.calibrate()

    def calibrate(self) -> None:
        """Map the device's clock stamps onto time.perf_counter: of
        CALIBRATION_TRIES stamps, each bracketed by two host reads (the
        launch, a copy to pinned memory and the wait on a stream of its
        own, so that queued steps are not waited for), keep the tightest
        bracket: ``clock_offset_ns`` is its stamp less the bracket's
        midpoint, ``clock_error_ns`` half its width."""
        if self._clock is None:
            on_card = self.device.type == "cuda"
            row = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
            self._clock = (row, torch.zeros((1, 1), dtype=torch.int64,
                                            pin_memory=on_card),
                           torch.cuda.Stream(self.device) if on_card
                           else None)
        row, host, side = self._clock
        best = None
        for _ in range(CALIBRATION_TRIES):
            a = time.perf_counter_ns()
            if side is None:
                stamp(row, 0)
                t = int(row[0, 0])
            else:
                with torch.cuda.stream(side):
                    stamp(row, 0)
                    host.copy_(row, non_blocking=True)
                side.synchronize()
                t = int(host[0, 0])
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, t - (a + b) // 2)
        self.clock_error_ns = best[0] // 2
        self.clock_offset_ns = best[1]
        self._calibrated_at = time.perf_counter()

    def _stage_times(self, fid: int):
        """Standalone segmentation, then clustering, each waited for, as
        the reference times each stage in its callback
        (ref: src/processor.cpp:148-219); (seg s, cluster s). Each stage
        is a B = 1 step on the stream's route (``compiled.batched_step``:
        a graph on the card unless ``eager``), the JAX stream's ``_seg``
        and ``_cluster`` jits; the clustering stage's mask input is the
        segmentation stage's obstacle mask, copied device to device."""
        seg_stage, cl_stage = self._stages
        xyz = self.xyz[fid:fid + 1]
        t0 = time.perf_counter()
        _, obstacle = seg_stage(xyz, self.mask[fid:fid + 1])
        self.sync()
        t1 = time.perf_counter()
        cl_stage(xyz, obstacle)
        self.sync()
        return t1 - t0, time.perf_counter() - t1

    def _to_host(self, payload: torch.Tensor, stats: torch.Tensor,
                 slot: int):
        """Start the copies of the payload and the stats row to the host;
        (host payload, host stats, event)."""
        if payload.device.type != "cuda":
            # a compiled step's output is overwritten by the next step
            return payload.clone(), stats.clone(), None
        while len(self._pinned) <= slot:
            self._pinned.append(tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (payload, stats)))
        host, host_stats = self._pinned[slot]
        host.copy_(payload, non_blocking=True)
        host_stats.copy_(stats, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(payload.device))
        return host, host_stats, done

    def run(self, num_frames: int, realtime: bool = False,
            with_outlines: bool = True, stage_timing: bool = False):
        """Yield (FrameOutputs, FrameMetrics) for `num_frames` frames.

        realtime=True paces dispatch at replay_rate_hz, consumes each frame
        while the next publication is not yet due, and flags deadline
        misses (the reference's 100 ms budget, ref: README.md:4).
        stage_timing=True times segmentation/clustering/hulls separately
        (synchronously — lower throughput, richer metrics). No span stays
        open across a yield.
        """
        period = 1.0 / self.config.pipeline.replay_rate_hz
        self.warmup()
        if stage_timing and self._stages is None:
            # built (on the card: captured) before the first timed frame
            self._stages = tuple(compiled.batched_step(
                fn, self.config, 1, self.device, self.eager)
                for fn in (segment_stage, cluster_stage))
        inflight: List[_InFlight] = []
        depth = self.config.pipeline.queue_depth
        produced = 0
        seq = 0               # publication sequence number (cyclic fids)
        t_start = time.perf_counter()

        while produced < num_frames:
            if time.perf_counter() - self._calibrated_at > RECALIBRATE_S:
                self.calibrate()
            spans = Spans()
            dropped_before = 0
            if realtime:
                # publication clock: seq k publishes at t_start + k*period
                # regardless of consumer progress (ref:
                # src/dataloader.cpp:30,80-81); with keep-last-`depth` QoS
                # (ref: src/processor.cpp:69-73) frames published beyond
                # the window while the consumer was busy are DROPPED
                now = time.perf_counter()
                published = int((now - t_start) / period) + 1
                if published <= seq:
                    spans.begin("stream.publication_wait")
                    time.sleep(t_start + seq * period - now)
                    published = seq + 1
                newest_kept = max(seq, published - depth)
                dropped_before = newest_kept - seq
                seq = newest_kept
            fid = seq % self.num_frames
            t0 = spans.begin("stream.dispatch")
            stages = self._stage_times(fid) if stage_timing else None
            # a ring of depth + 1 pinned buffers: the slot reused here
            # belonged to a frame that has already been consumed
            host, host_stats, done = self._to_host(*self._step(fid),
                                                   produced % (depth + 1))
            t_dispatched = spans.end()
            t_pub = t_start + seq * period if realtime else t0
            spans.record.insert(-1, ("stream.lag", t_pub, t0))
            produced += 1
            inflight.append(_InFlight(fid, seq, t_pub, t0, t_dispatched,
                                      spans.record, host, host_stats, done,
                                      stages, dropped_before))
            seq += 1
            # bounded window: consume the oldest once the queue is full
            while len(inflight) > depth:
                yield self._consume(inflight.pop(0), period, with_outlines)
            # realtime: consume while the next publication leaves time;
            # once it is due, dispatch it first and let the window bound
            while realtime and inflight and (
                    time.perf_counter() < t_start + seq * period):
                yield self._consume(inflight.pop(0), period, with_outlines,
                                    early=True)
        while inflight:
            yield self._consume(inflight.pop(0), period, with_outlines)

    def _consume(self, f: "_InFlight", period: float, with_outlines: bool,
                 early: bool = False):
        consumed = Spans()
        t_wait = consumed.begin("stream.device_wait")
        if f.done is not None:
            f.done.synchronize()
        t1 = consumed.begin("host.decode")
        n = int(self.counts[f.fid])
        out = host_outputs_packed(f.host.numpy().copy(), self.config, n,
                                  intensity=self.intensity[f.fid, :n],
                                  with_outlines=with_outlines,
                                  spans=consumed)
        t2 = consumed.begin("host.counts")
        seg = out.seg_labels
        ground, obstacle = int(np.sum(seg == 1)), int(np.sum(seg == 2))
        t_out = consumed.end()
        t0 = f.t_dispatch
        t_seg = t_cl = t_hull = None
        if f.stages is not None:
            t_seg, t_cl = f.stages[0] * 1e3, f.stages[1] * 1e3
            # hull stage = the fused step's completion less the timed
            # prefix stages (the fused step recomputes seg + cluster; its
            # marginal hull cost is the rest of the dispatch window)
            t_hull = max(0.0, (t1 - t0) * 1e3 - t_seg - t_cl)
        stats = f.host_stats.tolist()
        stamps = stats[:len(STAGES) + 1]
        at = [(s - self.clock_offset_ns) * 1e-9 for s in stamps]
        # the device's track starts with the dispatch: the queue runs to
        # the first stamp (the device's start latency; the step begins
        # while the launch call is still returning), the stages follow,
        # and the hold runs from the later of the last stamp and the
        # dispatch's return to the wait, empty where the wait began first
        # (a realtime frame consumed before the next publication)
        last = max(f.t_dispatched, at[-1])
        device = ([("stream.queue", f.t_dispatch, max(f.t_dispatch, at[0]))]
                  + [(name, at[i], at[i + 1])
                     for i, name in enumerate(STAGES)]
                  + [("stream.hold", last, max(last, t_wait))])
        metrics = FrameMetrics(
            frame_id=f.fid,
            t_dispatch_ms=(t1 - t0) * 1e3,
            t_host_ms=(t2 - t1) * 1e3,
            ground_points=ground,
            obstacle_points=obstacle,
            num_clusters=out.num_clusters,
            num_outlines=len(out.outlines),
            overflow=out.overflow,
            deadline_missed=t_out - f.t_published > period,
            frames_dropped=f.dropped_before,
            t_seg_ms=t_seg, t_cluster_ms=t_cl, t_hull_ms=t_hull,
            seq=f.seq, t_published=f.t_published,
            spans=f.spans + device + consumed.record,
            device_ms={name: (stamps[i + 1] - stamps[i]) * 1e-6
                       for i, name in enumerate(STAGES)},
            counters=(dict(zip(COUNTERS, stats[len(STAGES) + 1:]))
                      if self.config.pipeline.clustering_backend == "stixel"
                      else {}),
            consumed_early=early,
        )
        return out, metrics


class _InFlight(NamedTuple):
    """A dispatched frame waiting in the window."""

    fid: int
    seq: int
    t_published: float
    t_dispatch: float         # its stream.dispatch span's start and end
    t_dispatched: float
    spans: List[Span]         # [stream.publication_wait,] lag, dispatch
    host: torch.Tensor        # the payload's host copy (landing)
    host_stats: torch.Tensor  # the stats row's host copy (landing)
    done: Optional[torch.cuda.Event]   # set when both have landed
    stages: Optional[tuple]   # stage-timed replay: (seg s, cluster s)
    dropped_before: int
