"""Headline benchmark of the PyTorch port: frames/sec on one GPU.

    python -m lidar_processing_tpu_torch.bench [--device cuda] \\
        [--data-dir DIR] [--frames N] [--batches 4 8] [--golden FILE] \\
        [--eager]
    python -m lidar_processing_tpu_torch bench ...      # the same, via the CLI

The counterpart of the repo's root ``bench.py`` (the JAX package's),
over the frames of ``--data-dir`` (default: the checkout's ``data/``, the
KITTI sequence; FileNotFoundError when absent, as there). It covers all
three reference stages (segment -> cluster -> polygonize,
ref: src/processor.cpp:135-219). On the card every step is the compiled
step (runtime/compiled.py: ``device_frame_step_batched`` captured once per
B as a CUDA graph and replayed, as root bench.py jits its step);
``--eager`` times the eager step, which the CPU always runs:

  * device throughput at B=1: the step over every frame,
    waited for once per pass, best of 3 passes;
  * batched device throughput: for each B of ``--batches`` (4 and 8),
    the step over the resident frames B at a time
    (the frame count rounded down to a multiple of B; when B exceeds it,
    one batch of the frames repeated cyclically), ms per frame of one
    pass after one warmup call, as root bench.py times its vmap. B is
    the number of frames one step takes: every
    op and both kernels launch once for the B frames, which spreads the
    host's per-launch cost over them (root bench.py's vmap);
  * END-TO-END ms/frame through ``ReplayStream`` (the host outlines of
    frame k overlap the device step of frame k+1, ``queue_depth`` 2), less
    one warmup step, best of 2 passes; the host stage's p50 from the same
    pass;
  * accuracy spot-check against the host oracles on the first, middle
    and last frame: oracle GPF (oracle/reference.py), then exact radius-CC
    and serial FEC labels through the native module, as
    tools/golden_run.py computes them (root bench.py gets the same labels
    from run_pipeline, which also builds every outline in Python).

``ms_per_frame`` is the best of B=1 and every batched B, ``batch`` the B
that gave it, ``ms_per_frame_b1`` the B=1 number; ``value`` (frames/s)
and ``vs_baseline`` follow from the best, as in root bench.py. Prints ONE
JSON line with the root bench.py's keys (``backend`` is "cuda" or "cpu",
``device`` names the card, ``step`` is "graph" or "eager");
``vs_baseline`` is relative to the reference's 10 Hz budget
(ref: README.md:4). ``golden_154`` comes only from a golden
file of the port given with ``--golden`` (tools/golden_run.py writes one),
never from the root GOLDEN.json, which holds the JAX package's TPU
figures.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from .config import DEFAULT_CONFIG

GOLDEN_KEYS = ("n_frames", "iou_min", "f1_min", "cluster_exact_frames",
               "overflow_frames", "fec_f1_mean", "fec_band_mean")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--batches", type=int, nargs="*", default=[4, 8],
                    help="frames per batched step to measure beside B=1 "
                         "(default 4 8; none: B=1 only)")
    ap.add_argument("--golden", default=None)
    ap.add_argument("--eager", action="store_true",
                    help="time the eager step (every op launched from "
                         "Python) instead of the compiled step")
    args = ap.parse_args(argv)
    config = DEFAULT_CONFIG

    from .oracle import diff as odiff
    from .oracle.reference import (fec_cluster, gpf_segment,
                                   radius_cc_cluster)
    from .runtime.compiled import batched_step, uses_graph
    from .runtime.pipeline import device_frame_step_batched
    from .runtime.stream import ReplayStream
    from .types import SEG_OBSTACLE

    stream = ReplayStream(config, data_dir=args.data_dir, device=args.device,
                          eager=args.eager)
    dev = stream.device
    n_frames = min(args.frames or stream.num_frames, stream.num_frames)

    def stepper(b: int):
        """The batched step of B frames on the route asked for."""
        return batched_step(device_frame_step_batched, config, b, dev,
                            args.eager)

    step_b1 = stepper(1)

    def step(f: int):
        return step_b1(stream.xyz[f:f + 1], stream.mask[f:f + 1])

    def pass_ms(calls, n: int) -> float:
        """ms per frame of one pass of `calls` (n frames), waited for at
        its end."""
        t0 = time.perf_counter()
        for call in calls:
            call()
        stream.sync()
        return (time.perf_counter() - t0) / n * 1e3

    # --- B=1 device throughput (best of 3 passes: steady state) -----------
    step(0)
    stream.sync()
    b1 = [functools.partial(step, f) for f in range(n_frames)]
    per_b = {1: min(pass_ms(b1, n_frames) for _ in range(3))}

    # --- batched device throughput (spreads the per-launch cost): one
    # warmup call, then one pass, as root bench.py times its vmap ---------
    for b in args.batches:
        n = max(b, n_frames // b * b)
        ids = torch.arange(n, device=dev) % n_frames
        step_b = stepper(b)
        calls = [functools.partial(step_b, stream.xyz[ids[i:i + b]],
                                   stream.mask[ids[i:i + b]])
                 for i in range(0, n, b)]
        calls[0]()
        stream.sync()
        per_b[b] = pass_ms(calls, n)
    best_b = min(per_b, key=per_b.get)

    # --- end to end through the replay window, host outlines included -----
    stream.warmup()
    ms_e2e, host_ms, n_outlines = float("inf"), [], 0
    for _ in range(2):
        t0 = time.perf_counter()
        stream.warmup()                  # run() starts with this step too
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = list(stream.run(n_frames))
        rep_ms = (time.perf_counter() - t0 - warm_s) / n_frames * 1e3
        if rep_ms < ms_e2e:
            ms_e2e = rep_ms
            host_ms = [m.t_host_ms for _, m in results]
            n_outlines = sum(m.num_outlines for _, m in results)

    # --- accuracy spot-check vs the host oracles: the exact radius-CC
    # contract, and FEC at the reference's quality 0.5 as a secondary
    # metric (order-sensitive; see ACCURACY.md)
    ious, f1s, fec_f1s = [], [], []
    for f in sorted({0, n_frames // 2, n_frames - 1}):
        n = int(stream.counts[f])
        xyz = stream.xyz[f, :n].cpu().numpy()
        fr = step(f)
        seg_dev = fr.seg.labels[0].cpu().numpy()[:n]
        cl_dev = fr.clustering.labels[0].cpu().numpy()[:n]
        oseg = gpf_segment(xyz, config.segmentation).labels
        obst = np.flatnonzero(oseg == SEG_OBSTACLE)
        ious.append(odiff.ground_mask_iou(seg_dev, oseg))
        f1s.append(odiff.cluster_f1(
            cl_dev[obst], radius_cc_cluster(xyz[obst], config.clustering))[0])
        fec_f1s.append(odiff.cluster_f1(
            cl_dev[obst], fec_cluster(xyz[obst], config.clustering))[0])

    fps = 1000.0 / per_b[best_b]
    result = {
        "metric": "frames_per_sec_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / 10.0,  # reference budget: 10 Hz
        "ms_per_frame": per_b[best_b],
        "batch": best_b,
        "ms_per_frame_b1": per_b[1],
        "ms_per_frame_e2e": ms_e2e,
        "host_outline_ms_p50": float(np.percentile(host_ms, 50)),
        "e2e_vs_budget": 100.0 / ms_e2e,
        "n_frames": n_frames,
        "outlines_per_frame": n_outlines / n_frames,
        "ground_iou_min": float(min(ious)),
        "cluster_f1_min": float(min(f1s)),
        "fec_quality05_f1_min": float(min(fec_f1s)),
        "backend": dev.type,
        "step": "graph" if uses_graph(dev, args.eager) else "eager",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if args.golden:
        with open(args.golden) as fh:
            g = json.load(fh)
        result["golden_154"] = {k: g[k] for k in GOLDEN_KEYS if k in g}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
