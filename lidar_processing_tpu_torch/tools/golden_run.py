"""Golden parity run of the PyTorch port: device pipeline vs host oracles.

    python -m lidar_processing_tpu_torch.tools.golden_run [--device cuda] \\
        [--data-dir DIR] [--frames N] [--out PATH]
    python -m lidar_processing_tpu_torch golden ...     # the same, via the CLI

The counterpart of the repo's ``tools/golden_run.py`` (the JAX package's),
with the same six checks on every frame of ``--data-dir`` (default: the
checkout's ``data/``) and the same exit code:

  1. ground-mask IoU (device GPF vs oracle GPF)            >= 0.99
  2. clustering EXACTNESS: device labels vs the native radius-CC oracle
     on the device's own obstacle mask                     == bit-identical
  3. end-to-end cluster F1 vs the full oracle pipeline
     (oracle seg -> oracle CC)                             >= 0.99
  4. overflow counters                                     == 0
  5. outlines: one per valid cluster
  6. FEC parity: device labels vs the faithful serial FEC oracle at the
     reference's cluster_quality=0.5 (order-SENSITIVE, see ACCURACY.md),
     inside FEC's own order-sensitivity band: the native FEC under K=4
     other equally valid point orders (reversed + 3 seeded shuffles),
     diffed against itself. Per frame the device F1 must clear the band
     minimum minus 0.05; over the run its mean must reach the mean band
     minimum.

The device step runs on the card unless ``--device`` names another; the
radius-CC and FEC oracles run through the port's native module
(ops/hull_native.py). Writes a summary to ``--out`` (default
``chiprun_out/golden_torch.json`` in the checkout, never the root
GOLDEN.json, which holds the JAX package's TPU run) and returns nonzero
on any violation.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ._common import resolve_device

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / \
    "golden_torch.json"


def fec_with_order(xyz: np.ndarray, ccfg, perm: np.ndarray) -> np.ndarray:
    """Native FEC under a permuted point order, labels mapped back to the
    original order (the permutation changes BFS seed and neighbour order,
    both artifacts of the reference, ref: src/clustering.cpp:70,90)."""
    from ..oracle.reference import fec_cluster
    lp = fec_cluster(np.ascontiguousarray(xyz[perm]), ccfg)
    out = np.empty_like(lp)
    out[perm] = lp
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    from ..io.dataset import list_frames, load_frame
    from ..io.synthetic import pad_frame
    from ..oracle import diff as odiff
    from ..oracle import reference as orc
    from ..runtime.pipeline import device_frame_step, host_outputs
    from ..types import SEG_OBSTACLE

    cfg = DEFAULT_CONFIG
    dev = resolve_device(args.device)
    paths = list_frames(args.data_dir) if args.data_dir else list_frames()
    frames = paths[: args.frames]

    ious, f1s = [], []
    fec_f1s, fec_band_mins = [], []
    n_exact = 0
    n_overflow = 0
    n_fec_in_band = 0
    bad: list = []
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i, path in enumerate(frames):
        xyz, _ = load_frame(path)
        n = xyz.shape[0]
        x, m = pad_frame(xyz, cfg.pipeline.max_points)
        fr = device_frame_step(torch.from_numpy(x).to(dev),
                               torch.from_numpy(m).to(dev), cfg)
        out = host_outputs(fr, cfg, n)

        # 1. segmentation IoU
        oseg = orc.gpf_segment(xyz, cfg.segmentation)
        iou = odiff.ground_mask_iou(out.seg_labels, oseg.labels)
        ious.append(float(iou))

        # 2. exact clustering on the device's own obstacle mask
        dev_obst = out.seg_labels == SEG_OBSTACLE
        dev_cl = out.cluster_labels[dev_obst]
        exact = bool(np.array_equal(
            dev_cl, orc.radius_cc_cluster(xyz[dev_obst], cfg.clustering)))
        n_exact += exact

        # 3. end-to-end F1 vs the full oracle
        o_obst = oseg.labels == SEG_OBSTACLE
        o_cl = orc.radius_cc_cluster(xyz[o_obst], cfg.clustering)
        f1, _ = odiff.cluster_f1(out.cluster_labels[o_obst], o_cl)
        f1s.append(float(f1))

        # 4./5. overflow + outline count (one per valid cluster)
        n_overflow += out.overflow != 0
        n_valid = out.num_clusters
        outline_ok = len(out.outlines) == n_valid

        # 6. FEC parity vs its own order-sensitivity band (ACCURACY.md)
        obst_xyz = np.ascontiguousarray(xyz[dev_obst])
        n_obst = obst_xyz.shape[0]
        fec_id = orc.fec_cluster(obst_xyz, cfg.clustering)
        perms = [np.arange(n_obst)[::-1].copy()] + [
            rng.permutation(n_obst) for _ in range(3)]
        band = min(
            odiff.cluster_f1(
                fec_with_order(obst_xyz, cfg.clustering, p), fec_id)[0]
            for p in perms)
        fec_f1, _ = odiff.cluster_f1(dev_cl, fec_id)
        fec_f1s.append(float(fec_f1))
        fec_band_mins.append(float(band))
        fec_ok = fec_f1 >= band - 0.05   # per-frame catastrophe guard
        n_fec_in_band += fec_f1 >= band

        if (iou < 0.99 or not exact or f1 < 0.99 or out.overflow
                or not outline_ok or not fec_ok):
            bad.append(dict(frame=i, iou=float(iou), exact=exact,
                            f1=float(f1), overflow=int(out.overflow),
                            outlines=len(out.outlines),
                            clusters=int(n_valid),
                            fec_f1=float(fec_f1),
                            fec_band_min=float(band)))
        if i % 25 == 0:
            print(f"[{i}/{len(frames)}] iou={iou:.5f} exact={exact} "
                  f"f1={f1:.5f} fec={fec_f1:.4f} band={band:.4f} "
                  f"ovf={out.overflow} ({time.time() - t0:.0f}s)",
                  flush=True)

    summary = dict(
        n_frames=len(frames),
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        iou_min=min(ious), iou_mean=float(np.mean(ious)),
        f1_min=min(f1s), f1_mean=float(np.mean(f1s)),
        cluster_exact_frames=n_exact,
        overflow_frames=n_overflow,
        fec_f1_min=min(fec_f1s), fec_f1_mean=float(np.mean(fec_f1s)),
        fec_band_min=min(fec_band_mins),
        fec_band_mean=float(np.mean(fec_band_mins)),
        fec_frames_in_band=n_fec_in_band,
        fec_f1_per_frame=[round(v, 5) for v in fec_f1s],
        fec_band_per_frame=[round(v, 5) for v in fec_band_mins],
        violations=bad,
        elapsed_s=round(time.time() - t0, 1),
    )
    # population-level FEC criterion (see module docstring item 6)
    if summary["fec_f1_mean"] < summary["fec_band_mean"]:
        bad.append(dict(
            frame=-1, reason="fec_f1_mean below mean FEC self-agreement "
            "band minimum", fec_f1_mean=summary["fec_f1_mean"],
            fec_band_mean=summary["fec_band_mean"]))
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("violations", "fec_f1_per_frame",
                                   "fec_band_per_frame")}), flush=True)
    if bad:
        print(f"FAIL: {len(bad)} frames violate the golden contract")
        for b in bad[:10]:
            print(" ", b)
        return 1
    print("PASS: all frames meet the golden contract")
    return 0


if __name__ == "__main__":
    sys.exit(main())
