"""Streaming replay runtime: the dataloader/processor node pair, on a GPU.

Port of ``lidar_processing_tpu/runtime/stream.py``. The reference runs a
dataloader that preloads all frames and republishes them cyclically at
10 Hz over DDS, and a processor that runs the pipeline in the subscriber
callback (ref: src/dataloader.cpp:128-175, src/processor.cpp:135-268), with
keep-last-2 QoS (ref: src/processor.cpp:69-85). Here the frames are
preloaded into device memory once and the replay loop indexes into the
resident buffer, so the steady state has no host->device traffic.

Each frame's packed payload (runtime/pipeline.py) is copied into a pinned
host buffer with ``non_blocking=True`` on the step's stream, and a CUDA
event marks when it has landed; at most ``queue_depth`` frames are in
flight, and the host decodes the oldest while the device runs the next.
Realtime mode keeps the DDS depth-``queue_depth`` semantics with a
publication clock: a slow consumer sees dropped frames, not growing lag.
On a CPU device the payload is already on the host and no event is used.
Per-stage metrics mirror the reference's timing logs
(ref: src/processor.cpp:167-171,204-207,218-219).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..io.dataset import list_frames, preload_padded
from ..ops import stixel as _stixel
from ..ops.segmentation import gpf_segment
from ..types import SEG_OBSTACLE
from .pipeline import device_frame_step_packed, host_outputs_packed


@dataclasses.dataclass
class FrameMetrics:
    """Per-frame observability record (ref: processor.cpp logging)."""

    frame_id: int
    t_dispatch_ms: float      # device step dispatch + completion
    t_host_ms: float          # host polygonization + readout
    ground_points: int
    obstacle_points: int
    num_clusters: int
    num_outlines: int
    overflow: int
    deadline_missed: bool     # frame exceeded the replay period
    # frames dropped immediately before this one because the in-flight
    # window was full when they were published (realtime mode only —
    # DDS QoS keep-last-`queue_depth`, ref: src/processor.cpp:69-73)
    frames_dropped: int = 0
    # per-stage times (stage_timing=True only; mirrors the reference's
    # separate seg/cluster/polygonize logs, ref: src/processor.cpp:167-168,
    # 204-205,218-219). TRIAGE-GRADE: seg and cluster are standalone steps,
    # each waited for, and t_hull is the fused step's residual after
    # subtracting them, so the split differs from the fused step's true
    # internals (which share sorts across stages); for optimization use
    # the device traces (torch.profiler, tools/step_bench.py).
    t_seg_ms: Optional[float] = None
    t_cluster_ms: Optional[float] = None
    t_hull_ms: Optional[float] = None


class ReplayStream:
    """Device-resident cyclic frame replayer with a bounded in-flight window.

    Runs on the card (``device=None`` means ``cuda``, and raises where
    there is none); the CPU only when the caller passes ``device="cpu"``.

    Usage:
        stream = ReplayStream(config, data_dir)
        for out, metrics in stream.run(num_frames=154):
            ...
    """

    def __init__(self, config: EngineConfig,
                 data_dir: Optional[str] = None,
                 device: Optional[torch.device] = None):
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
        self._pinned: List[torch.Tensor] = []

    def _step(self, fid: int) -> torch.Tensor:
        return device_frame_step_packed(self.xyz[fid], self.mask[fid],
                                        self.config)

    def sync(self) -> None:
        """Wait for the work queued on the stream's device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """One step end to end: builds the kernels and warms the caches."""
        self._step(0)
        self.sync()

    def _stage_times(self, fid: int):
        """Standalone segmentation, then clustering, each waited for, as
        the reference times each stage in its callback
        (ref: src/processor.cpp:148-219); (seg s, cluster s)."""
        cfg = self.config
        xyz, mask = self.xyz[fid], self.mask[fid]
        t0 = time.perf_counter()
        seg = gpf_segment(xyz, mask, cfg.segmentation)
        obstacle = mask & (seg.labels == SEG_OBSTACLE)
        self.sync()
        t1 = time.perf_counter()
        _stixel.cluster(xyz, obstacle, cfg.clustering, cfg.pipeline)
        self.sync()
        return t1 - t0, time.perf_counter() - t1

    def _to_host(self, payload: torch.Tensor, slot: int):
        """Start the payload's copy to the host; (host tensor, event)."""
        if payload.device.type != "cuda":
            return payload, None
        while len(self._pinned) <= slot:
            self._pinned.append(torch.empty(payload.shape, dtype=payload.dtype,
                                            pin_memory=True))
        host = self._pinned[slot]
        host.copy_(payload, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(payload.device))
        return host, done

    def run(self, num_frames: int, realtime: bool = False,
            with_outlines: bool = True, stage_timing: bool = False):
        """Yield (FrameOutputs, FrameMetrics) for `num_frames` frames.

        realtime=True paces dispatch at replay_rate_hz and flags deadline
        misses (the reference's 100 ms budget, ref: README.md:4).
        stage_timing=True times segmentation/clustering/hulls separately
        (synchronously — lower throughput, richer metrics).
        """
        period = 1.0 / self.config.pipeline.replay_rate_hz
        self.warmup()
        # (fid, dispatch time, host buf, event, stage times, drops)
        inflight: List = []
        depth = self.config.pipeline.queue_depth
        produced = 0
        seq = 0               # publication sequence number (cyclic fids)
        t_start = time.perf_counter()

        while produced < num_frames:
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
                    time.sleep(t_start + seq * period - now)
                    published = seq + 1
                newest_kept = max(seq, published - depth)
                dropped_before = newest_kept - seq
                seq = newest_kept
            fid = seq % self.num_frames
            seq += 1
            t0 = time.perf_counter()
            stages = self._stage_times(fid) if stage_timing else None
            # a ring of depth + 1 pinned buffers: the slot reused here
            # belonged to a frame that has already been consumed
            host, done = self._to_host(self._step(fid), produced % (depth + 1))
            produced += 1
            inflight.append((fid, t0, host, done, stages, dropped_before))
            # bounded window: consume the oldest once the queue is full
            while len(inflight) > depth:
                yield self._consume(inflight.pop(0), period, with_outlines)
        while inflight:
            yield self._consume(inflight.pop(0), period, with_outlines)

    def _consume(self, item, period: float, with_outlines: bool):
        fid, t0, host, done, stages, dropped_before = item
        if done is not None:
            done.synchronize()
        t1 = time.perf_counter()
        n = int(self.counts[fid])
        out = host_outputs_packed(host.numpy().copy(), self.config, n,
                                  intensity=self.intensity[fid, :n],
                                  with_outlines=with_outlines)
        t2 = time.perf_counter()
        seg = out.seg_labels
        t_seg = t_cl = t_hull = None
        if stages is not None:
            t_seg, t_cl = stages[0] * 1e3, stages[1] * 1e3
            # hull stage = the fused step's completion less the timed
            # prefix stages (the fused step recomputes seg + cluster; its
            # marginal hull cost is the rest of the dispatch window)
            t_hull = max(0.0, (t1 - t0) * 1e3 - t_seg - t_cl)
        metrics = FrameMetrics(
            frame_id=fid,
            t_dispatch_ms=(t1 - t0) * 1e3,
            t_host_ms=(t2 - t1) * 1e3,
            ground_points=int(np.sum(seg == 1)),
            obstacle_points=int(np.sum(seg == 2)),
            num_clusters=out.num_clusters,
            num_outlines=len(out.outlines),
            overflow=out.overflow,
            deadline_missed=(t1 - t0) > period,
            frames_dropped=dropped_before,
            t_seg_ms=t_seg, t_cluster_ms=t_cl, t_hull_ms=t_hull,
        )
        return out, metrics
