"""Stixel-clustering cap occupancies over a frame directory.

    python -m lidar_processing_tpu_torch.tools.measure_caps \\
        [--data-dir DIR] [--device cuda]

The counterpart of the repo's ``tools/measure_caps.py``: every frame of
``--data-dir`` (default: the checkout's ``data/``) through segmentation
and ``ops/stixel.py::cluster_debug`` at DEFAULT_CONFIG, then the max over
the frames of every capacity-bound quantity, so the PipelineConfig caps
and tier tables can be sized: obstacle points, cells, supernodes,
columns, column pairs, supernode pairs, edges, the live edges left after
one hook round (what enters the connected-components fixpoint), the
tier occupancies and the expansion-band counts, beside the overflow, the
cluster count and the clustered points (what the packed payload
carries). Prints a line every 50 frames and the maxima; returns the
maxima. Runs on the card unless ``--device`` names another (it raises
without one).

``measure`` takes any frames and engine configuration, ``widened`` an
engine whose capacities no quantity is clipped by, and ``cap_table``
sets each maximum beside its cap and 1.2 times it, rounded up to a
multiple of 32 (the JAX package's sizing rule): a benchmark
configuration is sized from its own sweeps with them
(``lidarbench/size_caps.py``).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..ops.stixel import (_CHUNK_PAIRS_INTRA, _CHUNK_PAIRS_SNP,
                          _SN_PAIR_TIER_SLOTS)
from ._common import resolve_device

# each capacity-bound quantity's cap: a PipelineConfig field (an entry of
# it for a tuple), or a constant of the step
CAPS = {"n_obst": "max_obstacle_points", "n_cells": "max_cells",
        "n_sn": "max_supernodes", "n_cols": "max_columns",
        "n_cpairs": "max_column_pairs", "n_snp": "max_sn_pairs",
        "n_edges": "max_edges", "n_live": "max_live_edges",
        "tiers1": "intra_tier_slots", "tiers2": _SN_PAIR_TIER_SLOTS,
        "n_cls": "expansion_band_caps", "n_clustered": "payload_large_points",
        "num": "large_cluster_slots"}
_CHUNKED = {"tiers1": _CHUNK_PAIRS_INTRA, "tiers2": _CHUNK_PAIRS_SNP}


def _live_edges(dbg, s_cap: int) -> torch.Tensor:
    """Edges still straddling two labels after one hook round + four
    pointer jumps (the JAX tool's replica of the fixpoint's round 1)."""
    from ..ops.scan_utils import IMAX, scatter_drop, take
    e_u, e_v, e_ok = dbg["e_u"], dbg["e_v"], dbg["e_ok"]
    lab = torch.arange(s_cap, dtype=torch.int32, device=e_u.device)
    mn = torch.where(e_ok, torch.minimum(take(lab, e_u), take(lab, e_v)),
                     IMAX)
    for side in (e_u, e_v):
        hit = scatter_drop(s_cap, torch.where(e_ok, take(lab, side), s_cap),
                           mn, IMAX, "amin")
        lab = torch.minimum(lab, hit)
    for _ in range(4):
        lab = take(lab, lab)
    return (e_ok & (take(lab, e_u) != take(lab, e_v))).sum(dtype=torch.int32)


def frame_stats(xyz: torch.Tensor, mask: torch.Tensor, cfg) -> dict:
    """One padded frame's capacity-bound quantities (numpy values), its
    obstacles from the frame's own segmentation, and its clustered
    points. The points are clustered in the order the step clusters
    them (segmentation's sorted order, as ``cluster_fused`` takes them):
    which pairs the exact tests see depends on each cell's first point."""
    from ..ops.segmentation import gpf_segment_sorted
    from ..types import SEG_OBSTACLE
    ss = gpf_segment_sorted(xyz, mask, cfg.segmentation)
    out, res = _cluster_stats(ss.xyz, ss.valid & (ss.labels == SEG_OBSTACLE),
                              cfg)
    out["n_clustered"] = (res.labels >= 0).sum(dtype=torch.int32).numpy(
        force=True)
    return out


def cluster_stats(xyz: torch.Tensor, obstacle: torch.Tensor, cfg) -> dict:
    """The capacity-bound quantities of clustering `obstacle`'s points."""
    return _cluster_stats(xyz, obstacle, cfg)[0]


def _cluster_stats(xyz, obstacle, cfg):
    from ..ops import stixel as sx
    res, dbg = sx.cluster_debug(xyz, obstacle, cfg.clustering, cfg.pipeline)
    out = dict(
        n_obst=dbg["sp"].n_obst,
        n_cells=dbg["cells"].n_cells,
        n_sn=dbg["sn"].n_sn,
        n_cols=(dbg["col_sn_count"] > 0).sum(dtype=torch.int32),
        n_cpairs=dbg["n_cpairs"],
        n_snp=dbg["n_snp"],
        n_edges=dbg["e_ok"].sum(dtype=torch.int32),
        n_live=_live_edges(dbg, cfg.pipeline.max_supernodes),
        tiers1=dbg["tiers1"],
        tiers2=dbg["tiers2"],
        n_cls=dbg["n_cls"],
        overflow=res.overflow,
        num=res.num_clusters,
    )
    return {k: v.cpu().numpy() for k, v in out.items()}, res


def _sized(n: int) -> int:
    """1.2 times n, rounded up to a multiple of 32."""
    return -(-(n * 12) // (10 * 32)) * 32


def cap_table(maxima: dict, cfg) -> list:
    """(quantity, max, cfg's cap, 1.2x max rounded up to 32) rows; tier
    tables and bands a row each entry, their chunked-pair counts against
    the step's constant."""
    rows = []
    for k, field in CAPS.items():
        if k not in maxima:
            continue
        cap = getattr(cfg.pipeline, field) if isinstance(field, str) else field
        vals = np.atleast_1d(maxima[k]).tolist()
        if k == "num":
            # every cluster may need a host outline slot
            rows.append((k, vals[0], cap, _sized(vals[0])))
            continue
        caps = list(cap) if isinstance(cap, tuple) else [cap]
        if k in _CHUNKED:
            caps.append(_CHUNKED[k])
        for i, (v, c) in enumerate(zip(vals, caps)):
            name = k if len(caps) == 1 else f"{k}[{i}]"
            rows.append((name, int(v), int(c), _sized(int(v))))
    return rows


def widened(cfg, factor: float):
    """cfg with every capacity of CAPS `factor` times its own (the
    obstacle buffer at most the padded frame), so that no quantity is
    clipped by the cap it sizes."""
    pcfg = cfg.pipeline
    wide = {}
    for field in CAPS.values():
        if isinstance(field, str):
            v = getattr(pcfg, field)
            wide[field] = (tuple(int(x * factor) for x in v)
                           if isinstance(v, tuple) else int(v * factor))
    wide["max_obstacle_points"] = min(wide["max_obstacle_points"],
                                      pcfg.max_points)
    return cfg.replace(pipeline=dataclasses.replace(pcfg, **wide))


def measure(frames, cfg, dev) -> dict:
    """The maxima of frame_stats over `frames`, (name, xyz) pairs, each
    padded to cfg's max_points on `dev`; a line every 50 frames."""
    from ..io.synthetic import pad_frame
    maxima: dict = {}
    for i, (_, xyz) in enumerate(frames):
        x, m = pad_frame(xyz, cfg.pipeline.max_points)
        out = frame_stats(torch.from_numpy(x).to(dev),
                          torch.from_numpy(m).to(dev), cfg)
        for k, v in out.items():
            maxima[k] = np.maximum(maxima.get(k, v), v)
        if i % 50 == 0:
            print(f"frame {i}: " + " ".join(
                f"{k}={v}" for k, v in out.items() if v.ndim == 0),
                flush=True)
    return maxima


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..io.dataset import list_frames, load_frame

    dev = resolve_device(args.device)
    paths = list_frames(args.data_dir) if args.data_dir else list_frames()
    maxima = measure(((p, load_frame(p)[0]) for p in paths), DEFAULT_CONFIG,
                     dev)
    print(f"\n=== maxima over {len(paths)} frames ({dev.type}) ===")
    for k, v in maxima.items():
        print(f"{k:12s} {v}")
    return maxima


if __name__ == "__main__":
    main()
