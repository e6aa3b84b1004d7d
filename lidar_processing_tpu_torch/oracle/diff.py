"""Output-diff metrics: ground-mask IoU, cluster-assignment F1, hull distance.

These implement the BASELINE acceptance metrics ("ground-mask IoU >= 0.99,
cluster-assignment F1 >= 0.99 vs reference") used to diff the TPU engine
against the faithful host oracle (oracle/reference.py). A numpy-only copy of
``lidar_processing_tpu/oracle/diff.py`` for the PyTorch port.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..types import SEG_GROUND


def ground_mask_iou(labels_a: np.ndarray, labels_b: np.ndarray) -> float:
    """IoU of the GROUND masks of two per-point segmentation labelings."""
    a = labels_a == SEG_GROUND
    b = labels_b == SEG_GROUND
    union = int(np.logical_or(a, b).sum())
    if union == 0:
        return 1.0
    return float(np.logical_and(a, b).sum()) / union


def segmentation_accuracy(labels_a: np.ndarray, labels_b: np.ndarray) -> float:
    """Fraction of points with identical {UNKNOWN, GROUND, OBSTACLE} labels."""
    if labels_a.size == 0:
        return 1.0
    return float((labels_a == labels_b).mean())


def cluster_f1(
    labels_pred: np.ndarray, labels_true: np.ndarray
) -> Tuple[float, Dict[str, float]]:
    """Cluster-assignment F1 under best one-to-one cluster matching.

    Both labelings are per-point int arrays over the same point set; negative
    labels (INVALID/UNDEFINED) denote unclustered points. Clusters are matched
    greedily by overlap size (equivalent to Hungarian for the near-diagonal
    contingency tables these pipelines produce); matched-pair point overlaps
    count as true positives, remaining predicted/true cluster points as
    FP/FN. Unclustered points on both sides are ignored; disagreement on
    clustered-vs-not shows up as FP or FN.
    """
    pred_valid = labels_pred >= 0
    true_valid = labels_true >= 0

    pred_ids, pred_inv = np.unique(labels_pred[pred_valid], return_inverse=True)
    true_ids, true_inv = np.unique(labels_true[true_valid], return_inverse=True)
    n_pred, n_true = pred_ids.size, true_ids.size

    tp = 0
    if n_pred and n_true:
        both = pred_valid & true_valid
        pair_keys = (labels_pred[both].astype(np.int64) * (int(true_ids.max()) + 1)
                     + labels_true[both].astype(np.int64))
        keys, counts = np.unique(pair_keys, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        used_pred, used_true = set(), set()
        for k in order:
            p = int(keys[k] // (int(true_ids.max()) + 1))
            t = int(keys[k] % (int(true_ids.max()) + 1))
            if p in used_pred or t in used_true:
                continue
            used_pred.add(p)
            used_true.add(t)
            tp += int(counts[k])

    total_pred = int(pred_valid.sum())
    total_true = int(true_valid.sum())
    fp = total_pred - tp
    fn = total_true - tp
    denom = 2 * tp + fp + fn
    f1 = 1.0 if denom == 0 else 2.0 * tp / denom
    stats = {
        "tp": float(tp), "fp": float(fp), "fn": float(fn),
        "clusters_pred": float(n_pred), "clusters_true": float(n_true),
    }
    return f1, stats


def polygon_chamfer(poly_a: np.ndarray, poly_b: np.ndarray) -> float:
    """Symmetric chamfer distance between two polygons' vertex sets (meters).

    Vertex-set based (not edge-sampled); adequate for diffing hulls produced
    from the same underlying cluster points.
    """
    if poly_a.shape[0] == 0 or poly_b.shape[0] == 0:
        return float("inf")
    d = np.linalg.norm(poly_a[:, None, :] - poly_b[None, :, :], axis=-1)
    return float(d.min(axis=1).mean() + d.min(axis=0).mean()) / 2.0


def match_outlines(
    outlines_a: Sequence[np.ndarray], outlines_b: Sequence[np.ndarray]
) -> Tuple[float, int]:
    """Greedy centroid matching of two outline sets.

    Returns (mean chamfer over matched pairs, number of unmatched polygons).
    """
    if not outlines_a and not outlines_b:
        return 0.0, 0
    if not outlines_a or not outlines_b:
        return float("inf"), abs(len(outlines_a) - len(outlines_b))
    ca = np.stack([p.mean(axis=0) for p in outlines_a])
    cb = np.stack([p.mean(axis=0) for p in outlines_b])
    d = np.linalg.norm(ca[:, None, :] - cb[None, :, :], axis=-1)
    pairs: List[Tuple[int, int]] = []
    used_a, used_b = set(), set()
    for k in np.argsort(d, axis=None):
        i, j = int(k // d.shape[1]), int(k % d.shape[1])
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        pairs.append((i, j))
        if len(pairs) == min(len(outlines_a), len(outlines_b)):
            break
    chamfers = [polygon_chamfer(outlines_a[i], outlines_b[j]) for i, j in pairs]
    unmatched = len(outlines_a) + len(outlines_b) - 2 * len(pairs)
    return float(np.mean(chamfers)) if chamfers else 0.0, unmatched
