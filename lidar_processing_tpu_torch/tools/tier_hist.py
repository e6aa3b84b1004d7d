"""Histogram of ambiguous-pair side sizes, for exact-test tier design.

    python -m lidar_processing_tpu_torch.tools.tier_hist \\
        [--step 10] [--data-dir DIR] [--device cuda]

The counterpart of the repo's ``tools/tier_hist.py``: every ``--step``-th
frame of ``--data-dir`` (default: the checkout's ``data/``) through
segmentation and ``ops/stixel.py::cluster_debug`` at DEFAULT_CONFIG, then
the distribution of max(u_count, v_count) over the AMBIGUOUS pairs (the
ones that need exact block tests), intra-column and supernode pairs apart
(average and max per frame in each bin), the point-pair FLOPs the
supernode pairs need, and the supernode pairs' 2-D (min side, max side)
histogram of per-frame maxima. Tier (cap, slots) tables should cover the
measured mass with the fewest slots x window area. Returns the tables.
Runs on the card unless ``--device`` names another (it raises without
one).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ._common import resolve_device

BINS = [0, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256, 512, 2048, 10 ** 9]


def pair_sizes(dbg) -> tuple:
    """(intra max sides, supernode (min side, max side)) of the ambiguous
    pairs of one frame's cluster_debug dict (numpy)."""
    cnt = dbg["cells"].count.cpu().numpy()
    intra = []
    for k in (1, 2):
        act = dbg[f"intra_tests{k}"].cpu().numpy()
        intra.append(np.maximum(cnt, np.roll(cnt, -k))[act])
    snc = dbg["sn"].count.cpu().numpy()
    pu, pv = dbg["pu"].cpu().numpy(), dbg["pv"].cpu().numpy()
    amb = ((np.arange(len(pu)) < int(dbg["n_snp"]))
           & ~dbg["impossible"].cpu().numpy() & ~dbg["certain"].cpu().numpy())
    return (np.concatenate(intra), np.minimum(snc[pu], snc[pv])[amb],
            np.maximum(snc[pu], snc[pv])[amb])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step", type=int, default=10)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..io.dataset import list_frames, load_frame
    from ..io.synthetic import pad_frame
    from ..ops import stixel as sx
    from ..ops.segmentation import gpf_segment
    from ..types import SEG_OBSTACLE

    cfg = DEFAULT_CONFIG
    dev = resolve_device(args.device)
    paths = list_frames(args.data_dir) if args.data_dir else list_frames()
    frames = paths[::args.step]
    nb = len(BINS) - 1
    tot_intra = np.zeros(nb, np.int64)
    tot_snp = np.zeros(nb, np.int64)
    max_intra = np.zeros(nb, np.int64)
    max_snp = np.zeros(nb, np.int64)
    max_2d = np.zeros((nb, nb))
    flops_needed = 0.0
    for path in frames:
        x, m = (torch.from_numpy(a).to(dev) for a in pad_frame(
            load_frame(path)[0], cfg.pipeline.max_points))
        seg = gpf_segment(x, m, cfg.segmentation)
        _, dbg = sx.cluster_debug(x, m & (seg.labels == SEG_OBSTACLE),
                                  cfg.clustering, cfg.pipeline)
        intra, mn_snp, mx_snp = pair_sizes(dbg)
        h2, _, _ = np.histogram2d(mn_snp, mx_snp, (BINS, BINS))
        max_2d = np.maximum(max_2d, h2)
        hi, _ = np.histogram(intra, BINS)
        hs, _ = np.histogram(mx_snp, BINS)
        tot_intra += hi
        tot_snp += hs
        max_intra = np.maximum(max_intra, hi)
        max_snp = np.maximum(max_snp, hs)
        flops_needed += float(np.sum(mn_snp.astype(np.float64) * mx_snp) * 8)

    n = len(frames)
    lbls = [f"{BINS[i]}-{BINS[i + 1] if BINS[i + 1] < 10 ** 9 else 'inf'}"
            for i in range(nb)]
    print(f"frames sampled: {n} ({dev.type})")
    print(f"{'bin':>12s} {'intra avg':>10s} {'intra max':>10s} "
          f"{'snp avg':>10s} {'snp max':>10s}")
    for i in range(nb):
        print(f"{lbls[i]:>12s} {tot_intra[i] / n:10.1f} {max_intra[i]:10d} "
              f"{tot_snp[i] / n:10.1f} {max_snp[i]:10d}")
    print(f"true point-pair flops needed (snp, avg/frame): "
          f"{flops_needed / n / 1e6:.1f} MFLOP")
    print("\nsnp 2D MAX counts (rows=min side, cols=max side):")
    print(" " * 10 + " ".join(f"{lb:>9s}" for lb in lbls))
    for i, row in enumerate(max_2d):
        print(f"{lbls[i]:>10s}" + " ".join(f"{int(v):9d}" for v in row))
    return {"frames": n, "intra_total": tot_intra, "intra_max": max_intra,
            "snp_total": tot_snp, "snp_max": max_snp, "snp_2d_max": max_2d,
            "flops_per_frame": flops_needed / n}


if __name__ == "__main__":
    main()
