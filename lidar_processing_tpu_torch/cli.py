"""Launch-equivalent CLI of the PyTorch port: run the whole system with one
command, on the card unless ``--device`` names another.

The counterpart of ``lidar_processing_tpu/cli.py``: one process owns the
device-resident replay stream, the device pipeline, the host outlines,
per-frame metrics logging and optional visualization export
(ref: launch.sh:12-16 starts the dataloader + processor + RViz):

    python -m lidar_processing_tpu_torch run              # every frame
    python -m lidar_processing_tpu_torch run --realtime   # paced at 10 Hz
    python -m lidar_processing_tpu_torch run --stage-timing
    python -m lidar_processing_tpu_torch run --export-dir out --export-frames 0,77
    python -m lidar_processing_tpu_torch golden           # parity run (tools/golden_run.py)
    python -m lidar_processing_tpu_torch bench            # benchmark (bench.py)
    python -m lidar_processing_tpu_torch bench --batches 4 8   # B frames a step
    python -m lidar_processing_tpu_torch run --eager      # the eager step

Every subcommand takes ``--device`` (default ``cuda``; there is no silent
CPU fallback: with no GPU it raises unless given ``--device cpu``),
``--data-dir`` (default: the checkout's ``data/``) and ``--eager``: on the
card every subcommand runs the compiled step (runtime/compiled.py: the
step captured once as a CUDA graph and replayed, as the JAX package jits
it), and ``--eager`` the eager step, every op launched from Python, which
the CPU always runs; ``bench`` also takes
``--frames``, ``--batches`` (the batch sizes B measured beside B=1, each
step taking B frames at once; default 4 8: ``ms_per_frame`` is the best
of them, ``batch`` its B) and ``--golden FILE``; ``golden`` ``--frames``
and ``--out``.
"""

from __future__ import annotations

import argparse
import sys

from .config import DEFAULT_CONFIG


def _cmd_run(args) -> int:
    import numpy as np

    from .io.export import export_frame
    from .runtime.spans import total_ms
    from .runtime.stream import ReplayStream

    stream = ReplayStream(DEFAULT_CONFIG, data_dir=args.data_dir,
                          device=args.device,
                          eager=args.eager)
    n = args.frames if args.frames else stream.num_frames
    export_ids = (set(int(x) for x in args.export_frames.split(","))
                  if args.export_frames else set())

    disp, host, missed, overflow, dropped, early = [], [], 0, 0, 0, 0
    spans, stages, counters = {}, {}, {}    # name -> a value a frame
    for out, m in stream.run(n, realtime=args.realtime,
                             stage_timing=args.stage_timing):
        stage = ""
        if m.t_seg_ms is not None:
            stage = (f" seg={m.t_seg_ms:6.2f}ms clu={m.t_cluster_ms:6.2f}ms"
                     f" hull={m.t_hull_ms:6.2f}ms")
        print(f"frame {m.frame_id:3d}: dispatch={m.t_dispatch_ms:7.2f}ms "
              f"host={m.t_host_ms:6.2f}ms{stage} "
              f"ground={m.ground_points:6d} obst={m.obstacle_points:6d} "
              f"clusters={m.num_clusters:3d} outlines={m.num_outlines:3d}"
              f"{' DEADLINE' if m.deadline_missed else ''}"
              f"{' OVERFLOW' if m.overflow else ''}")
        disp.append(m.t_dispatch_ms)
        host.append(m.t_host_ms)
        missed += m.deadline_missed
        overflow += m.overflow
        dropped += m.frames_dropped
        early += m.consumed_early
        for name in dict.fromkeys(n for n, _, _ in m.spans):
            spans.setdefault(name, []).append(total_ms(m.spans, name))
        for into, values in ((stages, m.device_ms), (counters, m.counters)):
            for name, v in values.items():
                into.setdefault(name, []).append(v)
        if m.frame_id in export_ids and args.export_dir:
            fid = m.frame_id
            xyz = stream.xyz[fid, :int(stream.counts[fid])].cpu().numpy()
            paths = export_frame(args.export_dir, fid, xyz,
                                 out.seg_labels, out.cluster_labels,
                                 out.outlines, out.outline_cluster_ids,
                                 out.outline_z_extents,
                                 intensity=out.intensity)
            print(f"  exported: {', '.join(paths)}")

    print(f"\n{n} frames: dispatch p50={np.percentile(disp, 50):.2f}ms "
          f"p99={np.percentile(disp, 99):.2f}ms "
          f"host p50={np.percentile(host, 50):.2f}ms "
          f"deadline_missed={missed} overflow_frames={overflow} "
          f"frames_dropped={dropped} consumed_early={early}")
    for what, values, unit in (("spans", spans, "ms"),
                               ("device stages", stages, "ms"),
                               ("counters", counters, "")):
        print(f"{what} p50: " + " ".join(
            f"{name}={np.median(v):.{2 if unit else 0}f}{unit}"
            for name, v in values.items()))
    return 0


def main(argv=None) -> int:
    """Parse `argv` and run the subcommand. ``bench`` and
    ``golden`` hand their flags on to bench.py and tools/golden_run.py
    (``bench --help`` lists them)."""
    ap = argparse.ArgumentParser(prog="lidar_processing_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="replay stream + pipeline + metrics")
    run.add_argument("--device", default="cuda",
                     help="torch device (default cuda; cpu runs the plain "
                          "kernel twins)")
    run.add_argument("--data-dir", default=None)
    run.add_argument("--frames", type=int, default=None)
    run.add_argument("--realtime", action="store_true",
                     help="pace at replay_rate_hz (10 Hz, ref budget)")
    run.add_argument("--stage-timing", action="store_true",
                     help="time seg/cluster/hull stages separately")
    run.add_argument("--export-dir", default=None)
    run.add_argument("--export-frames", default=None,
                     help="comma-separated frame ids to export")
    run.add_argument("--eager", action="store_true",
                     help="the eager step instead of the compiled step "
                          "(one CUDA graph replay a frame)")
    sub.add_parser("bench", add_help=False,
                   help="headline benchmark (one JSON line): frames/s at "
                        "B=1 and batched B (--batches, default 4 8)")
    sub.add_parser("golden", add_help=False,
                   help="golden parity run vs the host oracles")

    args, rest = ap.parse_known_args(argv)
    if args.cmd == "bench":
        from . import bench
        bench.main(rest)
        return 0
    if args.cmd == "golden":
        from .tools import golden_run
        return golden_run.main(rest)
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    return _cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
