"""The port's device step on one GPU: kernels per step, device, host and
end-to-end p50, for one tree of the port or several compared in turns.

    python lidar_processing_tpu_torch/tools/step_bench.py
    python lidar_processing_tpu_torch/tools/step_bench.py \\
        --trees PARENT_DIR . --pairs 5 --out step_bench.json

Each measurement runs in a process of its own with the tree's root first
on ``sys.path`` (so an older checkout of the port, unpacked beside this
one, measures its own code): N synthetic street scenes (io/synthetic.py,
seeds 0..N-1) replayed through ``ReplayStream`` at ``DEFAULT_CONFIG``;
end to end = the replay's wall time less one warmup step, per frame;
host p50 = the stream's host decode + outlines; device p50 = CUDA events
around ``device_frame_step_packed`` (3 repeats a frame); and
torch.profiler's count of CUDA kernels (and of copies and fills) in one
step of frame 0, with their summed device time. Only entry points every
tree of the port has are used.

With several trees, pair i runs the trees in order when i is even and in
reverse when it is odd, so drift on the machine hits both sides alike;
the summary gives each tree's median and interquartile range. The script
needs a CUDA GPU and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_METRICS = ("kernels", "copies", "busy_ms", "device_p50_ms", "host_p50_ms",
            "e2e_ms")


def step_kernels(step) -> dict:
    """torch.profiler's count of CUDA kernels (and of memory copies and
    fills) that one call of `step` runs, and their summed device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    out = {"kernels": 0, "copies": 0, "busy_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        copy = e.key.startswith(("Memcpy", "Memset"))
        out["copies" if copy else "kernels"] += e.count
        out["busy_ms"] += e.self_device_time_total / 1e3
    return out


def write_frames(frames_dir: Path, n_frames: int) -> None:
    from lidar_processing_tpu_torch.io.pcd import write_pcd_xyzi
    from lidar_processing_tpu_torch.io.synthetic import street_scene
    for seed in range(n_frames):
        xyz, inten = street_scene(seed)
        write_pcd_xyzi(frames_dir / f"{seed:06d}.pcd", xyz, inten)


def _event_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def measure(tree: Path, frames_dir: Path, n_frames: int) -> dict:
    """One tree's step on the card (run in a fresh process)."""
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("step_bench: needs a CUDA GPU")
    import lidar_processing_tpu_torch as port
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_packed)
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream
    if Path(port.__file__).resolve().parents[1] != tree.resolve():
        raise SystemExit(f"step_bench: imported {port.__file__}, not the "
                         f"port of {tree}")
    dev = torch.device("cuda", 0)
    stream = ReplayStream(DEFAULT_CONFIG, data_dir=str(frames_dir),
                          device=dev)
    stream.warmup()                       # first run: kernel build, caches
    t0 = time.perf_counter()
    stream.warmup()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = list(stream.run(n_frames))  # run() warms up with one step
    run_s = time.perf_counter() - t0
    dev_ms = [_event_ms(lambda: device_frame_step_packed(
        stream.xyz[f], stream.mask[f], stream.config), 3)
        for f in range(stream.num_frames)]
    out = step_kernels(lambda: device_frame_step_packed(
        stream.xyz[0], stream.mask[0], stream.config))
    out.update(device_p50_ms=statistics.median(dev_ms),
               host_p50_ms=statistics.median(m.t_host_ms
                                             for _, m in results),
               e2e_ms=(run_s - warm_s) * 1e3 / n_frames,
               overflow=sum(m.overflow for _, m in results),
               device=torch.cuda.get_device_name(0))
    return out


def _run_one(tree: Path, frames_dir: Path, n_frames: int) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
           str(tree), "--frames-dir", str(frames_dir), "--frames",
           str(n_frames)]
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"step_bench on {tree} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _summary(runs):
    out = {}
    for k in _METRICS:
        vals = sorted(r[k] for r in runs)
        q = statistics.quantiles(vals, n=4) if len(vals) > 1 else vals * 3
        out[k] = {"median": statistics.median(vals), "q1": q[0],
                  "q3": q[2]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[str(_ROOT)])
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--frames-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        res = measure(Path(args.measure), Path(args.frames_dir), args.frames)
        print(json.dumps(res), flush=True)
        return res
    trees = [Path(t).resolve() for t in args.trees]
    runs = {str(t): [] for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        sys.path.insert(0, str(_ROOT))
        write_frames(Path(tmp), args.frames)
        for i in range(args.pairs):
            for tree in (trees if i % 2 == 0 else trees[::-1]):
                r = _run_one(tree, Path(tmp), args.frames)
                runs[str(tree)].append(r)
                print(f"pair {i} {tree.name or tree}: "
                      + ", ".join(f"{k} {r[k]:.3f}" for k in _METRICS),
                      flush=True)
    result = {"frames": args.frames, "pairs": args.pairs, "runs": runs,
              "summary": {t: _summary(r) for t, r in runs.items()}}
    for tree, summ in result["summary"].items():
        print(f"{tree}: " + ", ".join(
            f"{k} {v['median']:.3f} [{v['q1']:.3f}-{v['q3']:.3f}]"
            for k, v in summ.items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
