"""End-to-end frame pipeline: segment -> cluster -> polygonize.

Port of ``lidar_processing_tpu/runtime/pipeline.py``. The device step runs
ground segmentation, clustering, label-run sorting and small-cluster
convex hulls on the tensors' device: fused in sorted space on the default
``stixel`` backend, stage by stage on the ``cellgraph`` backend, as in the
JAX package; ``pack_host_payload`` then
folds everything the host needs into ONE int32 buffer with the JAX
package's word-for-word layout. On the host, large-cluster outlines run
over label-sorted run slices through the native C++ module
(ops/hull_native.py: one batched chi-shape call per frame, or convex hulls
on a thread pool), and every outline is capped by Visvalingam-Whyatt
simplification
(ref: src/processor.cpp:135-219, src/polygon_simplification.cpp:96-138).

The device step has no host syncs: no ``.item()``, no ``nonzero``, no
boolean-mask indexing and no Python branch on tensor values — every shape
is static and caps count their overflow, which is what lets the port
match the JAX package bit for bit.

The step runs on a batch of B frames (``device_frame_step_batched``, the
counterpart of ``jax.vmap(device_frame_step)``): every op and both kernels
take the frame axis, so a batch costs one launch of each op, and every
counter stays per frame. Frame b of a batch gives bit for bit what it
gives alone; the per-frame ``device_frame_step`` is the batch of one.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..ops import clustering as _cellgraph
from ..ops import stixel as _stixel
from ..ops import hull_native
from ..ops.hull import (LabelRuns, convex_hulls_batched, gather_runs,
                        label_runs, label_runs_presorted)
from ..ops.scan_utils import compact_mask, scatter_drop, set_drop, sort_by
from ..ops.segmentation import gpf_segment, gpf_segment_sorted
from ..ops.simplify import simplify_ring
from ..types import (CLUSTER_UNDEFINED, ClusteringResult, PolygonBatch,
                     SegmentationResult, SEG_OBSTACLE, frame_of,
                     map_leaves)

_I32 = torch.int32

# two-tier outline extraction: small clusters take the device convex-hull
# path, large ones the host concave path
# (ref: src/polygon_simplification.cpp:98)
SMALL_P = 32          # padded points per small-cluster slot (device hulls)
SMALL_C = 1024        # small-cluster slots
LARGE_C = 512         # large-cluster (host concave) slots
NUM_SLOTS = SMALL_C + LARGE_C   # cluster-id table size


class FrameResult(NamedTuple):
    """One frame's device results; a batch adds a leading frame axis B to
    every leaf (counters (B,))."""

    seg: SegmentationResult
    clustering: ClusteringResult
    runs: LabelRuns               # label-sorted cloud + per-cluster runs
    small_ids: torch.Tensor       # (SMALL_C,) cluster id per small slot
    small_counts: torch.Tensor    # (SMALL_C,)
    n_small: torch.Tensor         # ()
    small_hulls: PolygonBatch     # device convex hulls of small clusters
    large_ids: torch.Tensor       # (LARGE_C,) cluster id per large slot
    n_large: torch.Tensor         # ()
    hull_overflow: torch.Tensor   # () slot-capacity violations


class FrameOutputs(NamedTuple):
    """Host-side per-frame outputs, mirroring the reference's four topics
    (ref: src/processor.cpp:221-267); outline_z_extents is the z range of
    each outline's cluster (ref: src/polygonization.hpp:35-49)."""

    seg_labels: np.ndarray        # (n,) int32
    cluster_labels: np.ndarray    # (n,) int32 (UNDEFINED for non-obstacle)
    num_clusters: int
    outlines: List[np.ndarray]    # ordered 2-D polygons, one per cluster
    outline_cluster_ids: List[int]  # cluster id of each outline
    outline_z_extents: List[tuple]  # (z_min, z_max) per outline
    overflow: int
    intensity: Optional[np.ndarray] = None


def device_frame_step_batched(xyzs: torch.Tensor, masks: torch.Tensor,
                              config: EngineConfig) -> FrameResult:
    """Full device pipeline for B padded frames.

    xyzs (B, N, 3) f32, masks (B, N) bool. On the stixel backend the
    stages are fused in sorted space: segmentation leaves its results in
    (partition, z) order, clustering consumes them directly and writes
    both label arrays back to original order with one sort, and the hull
    stage sorts the compacted obstacle buffers instead of the full padded
    clouds. Any other backend (``cellgraph``) runs stage by stage, as in
    the JAX package: segmentation, ``ops/clustering.py`` on the obstacle
    mask, ``label_runs`` over the full clouds. Every leaf of the result
    has a leading B.
    """
    if config.pipeline.clustering_backend == "stixel":
        ss = gpf_segment_sorted(xyzs, masks, config.segmentation)
        obstacle_s = ss.valid & (ss.labels == SEG_OBSTACLE)
        fused = _stixel.cluster_fused(
            ss.xyz, obstacle_s, ss.valid, ss.orig, ss.labels,
            config.clustering, config.pipeline)
        seg = SegmentationResult(fused.seg_labels, ss.planes, ss.plane_valid)
        runs = label_runs_presorted(
            fused.sorted_xyz, fused.sorted_label, fused.sorted_orig,
            NUM_SLOTS, orig_bound=xyzs.shape[1])
        return _hull_stage(seg, fused.result, runs, config)
    seg = gpf_segment(xyzs, masks, config.segmentation)
    obstacle = masks & (seg.labels == SEG_OBSTACLE)
    cl = _cellgraph.cluster(xyzs, obstacle, config.clustering,
                            config.pipeline)
    runs = label_runs(xyzs, cl.labels, NUM_SLOTS)
    return _hull_stage(seg, cl, runs, config)


def device_frame_step(xyz: torch.Tensor, mask: torch.Tensor,
                      config: EngineConfig) -> FrameResult:
    """device_frame_step_batched for one padded frame: xyz (N, 3), mask
    (N,); the result has no frame axis."""
    return frame_of(device_frame_step_batched(xyz[None], mask[None], config),
                    0)


def _hull_stage(seg: SegmentationResult, cl: ClusteringResult,
                runs: LabelRuns, config: EngineConfig) -> FrameResult:
    # device convex-hull path only handles up to SMALL_P points per cluster
    small_cut = min(config.polygonization.small_cluster_size, SMALL_P + 1)
    present = runs.counts > 0
    is_small = present & (runs.counts < small_cut)
    small_idx, n_small, ovf_s = compact_mask(is_small, SMALL_C)
    small_act = torch.arange(SMALL_C, dtype=_I32,
                             device=small_idx.device) < n_small[:, None]
    s_starts = torch.where(small_act,
                           runs.starts.gather(1, small_idx.long()), 0)
    s_counts = torch.where(small_act,
                           runs.counts.gather(1, small_idx.long()), 0)
    small_pts = gather_runs(runs.sorted_xyz, s_starts, s_counts, SMALL_P)
    small_hulls = convex_hulls_batched(
        small_pts[..., :2], s_counts, min(SMALL_P, small_cut + 1))

    large_idx, n_large, ovf_l = compact_mask(present & ~is_small, LARGE_C)
    hull_overflow = runs.overflow + ovf_s + ovf_l
    return FrameResult(seg, cl, runs, small_idx, s_counts, n_small,
                       small_hulls, large_idx, n_large, hull_overflow)


@functools.lru_cache(maxsize=1)
def _hull_pool() -> concurrent.futures.ThreadPoolExecutor:
    """Shared thread pool for the per-cluster convex hulls (the native
    calls drop the GIL, so threads scale over host cores)."""
    # oversubscribe ~4x: per-cluster times are lumpy (one 7k-point wall
    # next to hundreds of 30-point cars)
    workers = min(16, 4 * (os.cpu_count() or 2))
    return concurrent.futures.ThreadPoolExecutor(max_workers=workers)


def _outlines_from_slices(slices: List[np.ndarray],
                          config: EngineConfig) -> List[np.ndarray]:
    """Large-cluster outlines from per-cluster xy arrays, native C++.

    polygonizer_concave=True (default): chi-shape concave hulls, the
    reference's live path (ref: src/polygon_simplification.cpp:117-138),
    as ONE chi_hulls_batch call for the frame. False: convex outlines, with
    Chan's algorithm above chan_threshold points (the reference's
    findOrderedConvexOutlines, ref: src/polygon_simplification.cpp:32-63),
    one call per cluster on the thread pool. Clusters go largest first for
    load balance, and the results come back in their original order.
    """
    pcfg = config.polygonization
    m = len(slices)
    if m == 0:
        return []
    order = sorted(range(m), key=lambda k: -len(slices[k]))
    if pcfg.polygonizer_concave:
        offs = np.zeros(m + 1, np.int64)
        np.cumsum([len(slices[k]) for k in order], out=offs[1:])
        packed = np.ascontiguousarray(
            np.concatenate([slices[k] for k in order]), np.float32)
        hulls = hull_native.chi_hulls_batch(packed, offs, pcfg.chi)
    else:
        def convex(k: int) -> np.ndarray:
            xy = slices[k]
            algo = "chan" if len(xy) > pcfg.chan_threshold else "monotone"
            idx = hull_native.convex_hull_indices(xy, algorithm=algo)
            return xy[idx].astype(np.float32)
        hulls = _hull_pool().map(convex, order)
    results: List[np.ndarray] = [None] * m
    for k, h in zip(order, hulls):
        results[k] = h
    return results


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_frame(xyz_padded: torch.Tensor, mask: torch.Tensor,
              config: EngineConfig, n_points: Optional[int] = None,
              intensity: Optional[np.ndarray] = None) -> FrameOutputs:
    """Device step + host polygonization for one padded frame (the exact
    float32 readout)."""
    fr = device_frame_step(xyz_padded, mask, config)
    n = int(n_points) if n_points is not None else int(mask.sum())
    return host_outputs(fr, config, n, intensity=intensity)


def host_outputs(fr: FrameResult, config: EngineConfig,
                 n: int, intensity: Optional[np.ndarray] = None,
                 with_outlines: bool = True) -> FrameOutputs:
    """Exact (float32) readout + polygonization of one frame's device
    FrameResult (``frame_of(batched, b)`` for frame b of a batch).

    The streaming runtime uses the slimmer quantized single-buffer path
    (device_frame_step_packed + host_outputs_packed) instead.
    """
    sorted_xyz = _np(fr.runs.sorted_xyz)
    starts = _np(fr.runs.starts)
    counts = _np(fr.runs.counts)
    large_ids = _np(fr.large_ids)
    n_large = int(fr.n_large)
    slices = [
        sorted_xyz[int(starts[int(large_ids[k])]):
                   int(starts[int(large_ids[k])])
                   + int(counts[int(large_ids[k])]), :2]
        for k in range(n_large)]

    def zext(c: int):
        s, cnt = int(starts[c]), int(counts[c])
        zs = sorted_xyz[s:s + cnt, 2]
        return ((float(zs.min()), float(zs.max())) if cnt > 0
                else (0.0, 0.0))

    return _assemble_outputs(
        seg_labels=_np(fr.seg.labels), cl_labels=_np(fr.clustering.labels),
        small_ids=_np(fr.small_ids), n_small=int(fr.n_small),
        sh_v=_np(fr.small_hulls.vertices), sh_n=_np(fr.small_hulls.counts),
        large_ids=large_ids, n_large=n_large, large_slices=slices,
        zext=zext, num_clusters=int(fr.clustering.num_clusters),
        overflow=int(fr.clustering.overflow) + int(fr.hull_overflow),
        config=config, n=n, intensity=intensity,
        with_outlines=with_outlines)


def _assemble_outputs(seg_labels, cl_labels, small_ids, n_small, sh_v, sh_n,
                      large_ids, n_large, large_slices, zext,
                      num_clusters, overflow, config: EngineConfig, n: int,
                      intensity=None, with_outlines=True) -> FrameOutputs:
    """Build FrameOutputs from host arrays (shared by the exact and
    packed-payload readout paths). zext(c) -> (z_min, z_max) per slot."""
    inten = np.asarray(intensity)[:n] if intensity is not None else None
    if not with_outlines:
        return FrameOutputs(
            seg_labels=seg_labels[:n], cluster_labels=cl_labels[:n],
            num_clusters=num_clusters, outlines=[], outline_cluster_ids=[],
            outline_z_extents=[], overflow=overflow, intensity=inten)
    outlines: List[np.ndarray] = []
    outline_ids: List[int] = []
    for c in range(n_small):
        k = int(sh_n[c])
        if k > 0:
            outlines.append(sh_v[c, :k].astype(np.float32))
            outline_ids.append(int(small_ids[c]))

    outlines.extend(_outlines_from_slices(large_slices, config))
    outline_ids.extend(int(large_ids[k]) for k in range(n_large))

    # vertex-count cap (ref: src/polygonization.hpp:56 max_polygon_points)
    pcfg = config.polygonization
    if pcfg.simplify_convex_by_maximum_points:
        outlines = [simplify_ring(o, pcfg.max_points_in_polygon)
                    for o in outlines]

    return FrameOutputs(
        seg_labels=seg_labels[:n], cluster_labels=cl_labels[:n],
        num_clusters=num_clusters, outlines=outlines,
        outline_cluster_ids=outline_ids,
        outline_z_extents=[zext(c) for c in outline_ids],
        overflow=overflow, intensity=inten)


# --------------------------------------------------------------------------
# Packed host payload: everything the streaming readout needs, as ONE slim
# int32 device buffer (one device->host copy per frame). Layout (int32
# words), identical to the JAX package's:
#   header (8): n_small, n_large, num_clusters, overflow, n_large_pts,
#               origin_x (f32 bits), origin_y (f32 bits),
#               quantization scale (f32 bits)
#   labels   (N/2)        two 13-bit codes per word (lo | hi<<16)
#   zmin     (S) f32 bits; zmax (S) f32 bits
#   small_ids (SC); sh_counts (SC)
#   sh_vq    (SC*P_out)   one word per vertex: x_q | y_q<<16 (u16 halves)
#   large_ids (LC); large_counts (LC)
#   large_xy_q (LP)       one word per point: x_q | y_q<<16
# --------------------------------------------------------------------------

# dynamic per-frame quantization: scale = 65535 / max(span_x, span_y),
# clamped to [16, 8192] (~1 mm grid on KITTI-sized frames)
_Q_MIN, _Q_MAX = 16.0, 8192.0


def _payload_dims(config: EngineConfig):
    small_cut = min(config.polygonization.small_cluster_size, SMALL_P + 1)
    p_out = min(SMALL_P, small_cut + 1)
    # the sorted-run buffer has NO rows on the stixel backend, N on the
    # cellgraph backend; the large-point cap cannot exceed it
    rows = (config.pipeline.max_obstacle_points
            if config.pipeline.clustering_backend == "stixel"
            else config.pipeline.max_points)
    lp = min(config.pipeline.payload_large_points, rows)
    return (config.pipeline.max_points, config.pipeline.max_obstacle_points,
            NUM_SLOTS, SMALL_C, LARGE_C, p_out, lp)


def _quant(v, origin, scale):
    return torch.clamp(torch.round((v - origin) * scale), 0, 65535).to(_I32)


def _pack16(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo | hi << 16 as the int32 word with those bits (two's complement
    wrap done in int64, so it does not rest on int32 shift overflow)."""
    w = lo.long() | (hi.long() << 16)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(_I32)


def pack_host_payload(fr: FrameResult, config: EngineConfig) -> torch.Tensor:
    """Batched FrameResult -> the (B, words) int32 payloads (layout above,
    one row per frame); one frame's FrameResult -> its (words,)."""
    if fr.clustering.labels.dim() == 1:
        return pack_host_payload(map_leaves(lambda t: t[None], fr),
                                 config)[0]
    N, NO, S, SC, LC, p_out, LP = _payload_dims(config)
    dev = fr.clustering.labels.device
    frames = fr.clustering.labels.shape[0]

    # 13-bit label codes, two per word
    cl = fr.clustering.labels
    cl_enc = torch.where(cl == CLUSTER_UNDEFINED, 0, cl + 2)
    code = (cl_enc << 2) | fr.seg.labels
    labels_packed = _pack16(code[:, 0::2], code[:, 1::2])

    skey = fr.runs.sorted_key                      # (B,NO) slot per row
    valid_row = skey < S
    z = fr.runs.sorted_xyz[..., 2]
    inf = float("inf")
    zmin = scatter_drop(S, skey, torch.where(valid_row, z, inf), inf, "amin")
    zmax = scatter_drop(S, skey, torch.where(valid_row, z, -inf), -inf,
                        "amax")
    zmin = torch.where(torch.isfinite(zmin), zmin, 0.0)
    zmax = torch.where(torch.isfinite(zmax), zmax, 0.0)

    # quantization origin: each frame's min corner over valid rows
    xy = fr.runs.sorted_xyz[..., :2]
    big = 3e38
    ox = torch.where(valid_row, xy[..., 0], big).amin(1)
    oy = torch.where(valid_row, xy[..., 1], big).amin(1)
    ox = torch.where(ox.abs() < big, ox, 0.0)
    oy = torch.where(oy.abs() < big, oy, 0.0)

    # dynamic quantization scale from the frame's xy span
    sx = torch.where(valid_row, xy[..., 0], -big).amax(1) - ox
    sy = torch.where(valid_row, xy[..., 1], -big).amax(1) - oy
    span = torch.clamp(torch.maximum(sx, sy), min=1e-3)
    # a true f32 division, as XLA does: torch computes `65535.0 / span`
    # (and, on CUDA, `tensor / scalar`) as a reciprocal times, a ULP off
    scale = torch.clamp(torch.full_like(span, 65535.0) / span, _Q_MIN, _Q_MAX)

    # large-cluster point compaction: one sort brings large-run rows
    # (already in ascending cluster order) to the front
    act_l = torch.arange(LC, dtype=_I32, device=dev) < fr.n_large[:, None]
    is_large_slot = set_drop(
        torch.zeros((frames, S + 1), dtype=torch.bool, device=dev),
        torch.where(act_l, fr.large_ids, S + 1), True)
    pt_large = is_large_slot.gather(1, skey.long())
    xy_q = _pack16(_quant(xy[..., 0], ox[:, None], scale[:, None]),
                   _quant(xy[..., 1], oy[:, None], scale[:, None]))
    pos = torch.arange(xy.shape[1], dtype=_I32, device=dev)
    sort_key = torch.where(pt_large, pos, 2 ** 30)
    _, xy_q_sorted = sort_by(sort_key, xy_q)
    large_xy_q = xy_q_sorted[:, :LP]
    n_large_pts = pt_large.sum(1, dtype=_I32)
    pay_ovf = torch.clamp(n_large_pts - LP, min=0)
    large_counts = torch.where(
        act_l, fr.runs.counts.gather(1, fr.large_ids.long()), 0)

    verts = fr.small_hulls.vertices                # (B,SC,p_out,2)
    sh_q = _pack16(_quant(verts[..., 0], ox[:, None, None],
                          scale[:, None, None]),
                   _quant(verts[..., 1], oy[:, None, None],
                          scale[:, None, None]))

    f32_bits = torch.stack([ox, oy, scale], 1).view(_I32)
    header = torch.cat([
        torch.stack([
            fr.n_small, fr.n_large, fr.clustering.num_clusters,
            fr.clustering.overflow + fr.hull_overflow + pay_ovf,
            torch.clamp(n_large_pts, max=LP)], 1).to(_I32),
        f32_bits], 1)
    return torch.cat([
        header, labels_packed, zmin.view(_I32), zmax.view(_I32),
        fr.small_ids, fr.small_hulls.counts.to(_I32),
        sh_q.reshape(frames, -1), fr.large_ids, large_counts.to(_I32),
        large_xy_q], 1)


def device_frame_step_packed_batched(xyzs: torch.Tensor, masks: torch.Tensor,
                                     config: EngineConfig) -> torch.Tensor:
    """device_frame_step_batched + one host payload per frame: (B, words)
    int32 (the streaming path's buffer, a row per frame)."""
    return pack_host_payload(device_frame_step_batched(xyzs, masks, config),
                             config)


def device_frame_step_packed(xyz: torch.Tensor, mask: torch.Tensor,
                             config: EngineConfig) -> torch.Tensor:
    """device_frame_step_packed_batched for one padded frame: (words,)."""
    return device_frame_step_packed_batched(xyz[None], mask[None],
                                            config)[0]


def host_outputs_packed(payload, config: EngineConfig, n: int,
                        intensity: Optional[np.ndarray] = None,
                        with_outlines: bool = True) -> FrameOutputs:
    """host_outputs from one frame's payload, (words,): a row of
    pack_host_payload's buffer (a tensor on any device, or a host
    array)."""
    buf = (_np(payload) if isinstance(payload, torch.Tensor)
           else np.asarray(payload))
    N, NO, S, SC, LC, p_out, LP = _payload_dims(config)
    o = 8
    labels_packed = buf[o:o + N // 2]; o += N // 2
    zmin = buf[o:o + S].view(np.float32); o += S
    zmax = buf[o:o + S].view(np.float32); o += S
    small_ids = buf[o:o + SC]; o += SC
    sh_n = buf[o:o + SC]; o += SC
    sh_q = buf[o:o + SC * p_out].view(np.uint32).reshape(SC, p_out)
    o += SC * p_out
    large_ids = buf[o:o + LC]; o += LC
    large_counts = buf[o:o + LC]; o += LC
    large_xy_q = buf[o:o + LP].view(np.uint32); o += LP
    if o != buf.shape[0]:
        raise ValueError(f"payload has {buf.shape[0]} words, layout {o}")

    n_small, n_large = int(buf[0]), int(buf[1])
    n_large_pts = int(buf[4])
    ox = float(buf[5:6].view(np.float32)[0])
    oy = float(buf[6:7].view(np.float32)[0])
    scale = float(buf[7:8].view(np.float32)[0])

    # decode labels (two 13-bit codes per word)
    w = labels_packed.view(np.uint32)
    code = np.empty(N, np.int32)
    code[0::2] = w & 0xFFFF
    code[1::2] = w >> 16
    seg_labels = (code & 3).astype(np.int32)
    cl_enc = code >> 2
    cl_labels = np.where(cl_enc == 0, CLUSTER_UNDEFINED,
                         cl_enc - 2).astype(np.int32)

    def dq(words: np.ndarray) -> np.ndarray:
        out = np.empty(words.shape + (2,), np.float32)
        out[..., 0] = ox + (words & 0xFFFF).astype(np.float32) / scale
        out[..., 1] = oy + (words >> 16).astype(np.float32) / scale
        return out

    sh_v = dq(sh_q)
    large_xy = dq(large_xy_q)
    ends = np.cumsum(large_counts[:n_large])
    slices = []
    for k in range(n_large):
        lo = int(ends[k]) - int(large_counts[k])
        hi = int(ends[k])
        # payload cap overflow: emit an empty hull
        slices.append(large_xy[lo:hi] if hi <= n_large_pts
                      else large_xy[lo:lo])

    def zext(c: int):
        return (float(zmin[c]), float(zmax[c]))

    return _assemble_outputs(
        seg_labels=seg_labels, cl_labels=cl_labels,
        small_ids=small_ids, n_small=n_small, sh_v=sh_v, sh_n=sh_n,
        large_ids=large_ids, n_large=n_large, large_slices=slices,
        zext=zext, num_clusters=int(buf[2]), overflow=int(buf[3]),
        config=config, n=n, intensity=intensity,
        with_outlines=with_outlines)
