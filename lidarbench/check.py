"""The comparison that decides ``correct``.

Every frame the window delivered is judged against the plain reference
(``lidarbench/reference``), which works each resident frame out again
from its points alone: ground labels by GPF in float64, clusters as the
exact components of the radius graph over the reference's own obstacle
points. Deliveries of one frame that are byte for byte alike are judged
once. The numbers, each the worst over the judged deliveries:

- ``seg_mismatch_share``: share of a frame's points whose ground label
  differs from the reference's;
- ``cluster_mismatch_share``: 1 - F1 of the cluster assignment against
  the reference's clusters (clusters matched greedily by overlap, as the
  port's oracle diff does);
- ``num_clusters_gap``: |clusters - the reference's clusters|;
- ``overflow``: the program's overflow counter (caps exceeded);
- ``outline_count_gap``: outlines beyond or short of one per cluster;
- ``zext_gap_m``: how far an outline's z extent lies from the z range of
  the points the program put in its cluster (exact: the same float32s);
- ``outline_vertex_gap_mm``: how far an outline vertex lies from the
  nearest point of its cluster (the payload quantises xy to its grid);
- ``outline_cover_gap_mm``: how far a point of a cluster lies outside
  its outline: a convex hull and a chi-shape both contain every point of
  their cluster (ref: src/polygon_simplification.cpp:98-138), up to the
  payload's grid;
- ``outline_area_gap_share``: the area by which the frame's outlines
  differ from the shapes the configuration asks for (``reference/
  chi_shape.py``: the chi-shape of the cluster's points with the
  configured chi, its convex hull below ``small_cluster_size`` points),
  summed over the frame's outlines, over the shapes' summed area: a
  convex hull in place of a chi-shape covers the cluster's concavities;
- ``outline_miss_share``: the share of the frame's outlines that differ
  from their shape by more than a tenth of the shape's area (and more
  than 0.01 m²), so that concavities lost on small clusters show too;
- ``outline_vertex_cap_excess``: vertices an outline has beyond
  ``max_points_in_polygon`` (the cap is on in the configuration).

The limits are per configuration (``lidarbench/limits/<config>.json``);
PERF.md gives the readings each was set from. This module and the
reference import nothing of the program: a delivery is read by its
fields (``seg_labels``, ``cluster_labels``, ``num_clusters``,
``overflow``, ``outlines``, ``outline_cluster_ids``,
``outline_z_extents``).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Sequence

import numpy as np

from .reference import chi_shape, geometry, gpf, radius_cc

NUMBERS = ("seg_mismatch_share", "cluster_mismatch_share", "num_clusters_gap",
           "overflow", "outline_count_gap", "zext_gap_m",
           "outline_vertex_gap_mm", "outline_cover_gap_mm",
           "outline_area_gap_share", "outline_miss_share",
           "outline_vertex_cap_excess")
MISS_SHARE, MISS_M2 = 0.1, 0.01    # an outline that misses its shape
SEG_OBSTACLE = 2
_BIG = 1e30          # stands for a gap that cannot be measured (JSON has no inf)


class Truth(NamedTuple):
    """The reference's answer for one frame."""

    seg: np.ndarray          # (n,) ground labels
    clusters: np.ndarray     # (n,) cluster ids, -1 outside any cluster
    num_clusters: int


def r2_of(engine: Dict) -> float:
    """The radius threshold as the configuration states it: float32."""
    return float(np.float32(engine["clustering"]["distance_squared"]))


def truth(xyz: np.ndarray, engine: Dict, device="cpu") -> Truth:
    """The reference's labels for an (n, 3) float32 frame; engine is the
    engine configuration as nested dicts of its fields."""
    seg = gpf.segment(xyz, engine["segmentation"])
    obs = np.flatnonzero(seg == SEG_OBSTACLE)
    cc = engine["clustering"]
    lab = radius_cc.cluster_labels(xyz[obs], r2_of(engine),
                                   cc["min_cluster_size"],
                                   cc["max_cluster_size"], device)
    clusters = np.full(xyz.shape[0], -1, np.int32)
    clusters[obs] = lab
    return Truth(seg, clusters, int(lab.max()) + 1 if lab.size else 0)


def cluster_f1(pred: np.ndarray, true: np.ndarray) -> float:
    """Cluster-assignment F1 under a greedy one-to-one matching by
    overlap; labels < 0 are outside any cluster."""
    pv, tv = pred >= 0, true >= 0
    both = pv & tv
    tp = 0
    if both.any():
        width = int(true[tv].max()) + 1
        keys, counts = np.unique(pred[both].astype(np.int64) * width
                                 + true[both], return_counts=True)
        used_p, used_t = set(), set()
        for k in np.argsort(-counts, kind="stable"):
            p, t = divmod(int(keys[k]), width)
            if p in used_p or t in used_t:
                continue
            used_p.add(p)
            used_t.add(t)
            tp += int(counts[k])
    denom = int(pv.sum()) + int(tv.sum())
    return 1.0 if denom == 0 else 2.0 * tp / denom


def _fit(labels, n: int, fill: int) -> np.ndarray:
    """labels as (n,) int64: cut to n, or filled with ``fill``."""
    a = np.asarray(labels).astype(np.int64)[:n]
    return np.concatenate([a, np.full(n - a.size, fill, np.int64)])


def judge_frame(xyz: np.ndarray, ref: Truth, out,
                engine: Dict) -> Dict[str, float]:
    """The numbers for one delivered frame against its reference."""
    poly_cfg = engine["polygonization"]
    n = xyz.shape[0]
    seg = _fit(out.seg_labels, n, -1)        # labels the frame does not have
    cl = _fit(out.cluster_labels, n, -1)     # count as wrong
    cl = np.where(cl >= 0, cl, -1)
    nc = int(out.num_clusters)
    ids = [int(c) for c in out.outline_cluster_ids]
    per_id = np.bincount([c for c in ids if 0 <= c < nc], minlength=nc)
    count_gap = (abs(len(out.outlines) - nc) + int((per_id != 1).sum())
                 + sum(1 for c in ids if not 0 <= c < nc))

    order = np.argsort(cl, kind="stable")
    bounds = np.searchsorted(cl[order], np.arange(nc + 1))
    zext = vgap = cover = gap_sum = area_sum = 0.0
    misses = excess = 0
    for c, poly, (z0, z1) in zip(ids, out.outlines, out.outline_z_extents):
        if not 0 <= c < nc:
            continue
        members = order[bounds[c]:bounds[c + 1]]
        if members.size == 0:
            zext = vgap = cover = _BIG
            continue
        pts = xyz[members]
        zext = max(zext, abs(float(z0) - float(pts[:, 2].min())),
                   abs(float(z1) - float(pts[:, 2].max())))
        poly = np.asarray(poly, np.float64).reshape(-1, 2)
        vgap = max(vgap, geometry.vertex_gap(poly, pts[:, :2]))
        cover = max(cover, geometry.cover_gap(poly, pts[:, :2]))
        gap, area = chi_shape.area_gap(poly, chi_shape.shape(
            pts[:, :2], poly_cfg["chi"], poly_cfg["small_cluster_size"]))
        gap_sum += gap
        area_sum += area
        misses += gap > max(MISS_SHARE * area, MISS_M2)
        if poly_cfg["simplify_convex_by_maximum_points"]:
            excess = max(excess,
                         poly.shape[0] - poly_cfg["max_points_in_polygon"])
    n_out = len(out.outlines)
    return {
        "seg_mismatch_share": float(np.mean(seg != ref.seg)) if n else 0.0,
        "cluster_mismatch_share": 1.0 - cluster_f1(cl, ref.clusters),
        "num_clusters_gap": float(abs(nc - ref.num_clusters)),
        "overflow": float(out.overflow),
        "outline_count_gap": float(count_gap),
        "zext_gap_m": min(zext, _BIG),
        "outline_vertex_gap_mm": min(vgap * 1e3, _BIG),
        "outline_cover_gap_mm": min(cover * 1e3, _BIG),
        "outline_area_gap_share": gap_sum / area_sum if area_sum else 0.0,
        "outline_miss_share": misses / n_out if n_out else 0.0,
        "outline_vertex_cap_excess": float(excess),
    }


def digest(out) -> str:
    """A hash of everything judged in a delivery."""
    h = hashlib.blake2b(digest_size=16)
    for a in (out.seg_labels, out.cluster_labels):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr((int(out.num_clusters), int(out.overflow),
                   [int(c) for c in out.outline_cluster_ids],
                   [(float(a), float(b)) for a, b in out.outline_z_extents])
                  ).encode())
    for poly in out.outlines:
        h.update(np.ascontiguousarray(poly, np.float32).tobytes())
        h.update(b"|")
    return h.hexdigest()


class Verdict(NamedTuple):
    numbers: Dict[str, float]
    limits: Dict[str, float]
    correct: bool
    judged: int              # distinct deliveries judged
    frames: int              # resident frames among them


def judge(frames: Sequence[np.ndarray], deliveries: Sequence, engine: Dict,
          limits: Dict[str, float], device="cpu") -> Verdict:
    """Judge deliveries [(frame index, outputs)] of the resident frames
    (each an (n, 3) float32 array) against the reference."""
    distinct: Dict[tuple, object] = {}
    for fid, out in deliveries:
        distinct.setdefault((fid, digest(out)), (fid, out))
    truths: Dict[int, Truth] = {}
    worst = {k: 0.0 for k in NUMBERS}
    for fid, out in distinct.values():
        if fid not in truths:
            truths[fid] = truth(frames[fid], engine, device)
        for k, v in judge_frame(frames[fid], truths[fid], out,
                                engine).items():
            worst[k] = max(worst[k], v)
    ok = bool(deliveries) and all(worst[k] <= limits[k] for k in NUMBERS)
    return Verdict(worst, {k: limits[k] for k in NUMBERS}, ok, len(distinct),
                   len(truths))


class ControlOutputs(NamedTuple):
    """The reference computed on bfloat16 coordinates, in the program's
    place: the fields of a delivery."""

    seg_labels: np.ndarray
    cluster_labels: np.ndarray
    num_clusters: int
    outlines: List[np.ndarray]
    outline_cluster_ids: List[int]
    outline_z_extents: List[tuple]
    overflow: int


def to_bfloat16(xyz: np.ndarray) -> np.ndarray:
    """float32 coordinates rounded to bfloat16 (nearest, ties to even)."""
    bits = np.ascontiguousarray(xyz, np.float32).view(np.uint32).astype(
        np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def control(xyz: np.ndarray, engine: Dict, device="cpu") -> ControlOutputs:
    """The control: segmentation, clusters and convex outlines worked
    out by the reference from the frame's coordinates in bfloat16, the
    precision next below the float32 the configuration states."""
    low = to_bfloat16(xyz)
    ref = truth(low, engine, device)
    outlines, ids, zext = [], [], []
    order = np.argsort(ref.clusters, kind="stable")
    bounds = np.searchsorted(ref.clusters[order], np.arange(ref.num_clusters + 1))
    for c in range(ref.num_clusters):
        pts = low[order[bounds[c]:bounds[c + 1]]]
        outlines.append(geometry.convex_hull(pts[:, :2]).astype(np.float32))
        ids.append(c)
        zext.append((float(pts[:, 2].min()), float(pts[:, 2].max())))
    return ControlOutputs(ref.seg, np.where(ref.clusters >= 0, ref.clusters,
                                            -1), ref.num_clusters, outlines,
                          ids, zext, 0)


def report_lines(verdict: Verdict) -> List[str]:
    """One line a number: name, value, limit."""
    return [f"check {k} {verdict.numbers[k]!r} limit {verdict.limits[k]!r} "
            f"{'ok' if verdict.numbers[k] <= verdict.limits[k] else 'FAILED'}"
            for k in NUMBERS]
