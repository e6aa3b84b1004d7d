"""The port's device step on one GPU: the eager step against the compiled
step (one CUDA graph) in turns, or several trees of the port in turns.

    python -m lidar_processing_tpu_torch.tools.step_bench \\
        [--frames 8] [--out step_bench.json]
    python -m lidar_processing_tpu_torch.tools.step_bench \\
        --trees PARENT_DIR . --pairs 5 --out step_bench.json

Routes (the default): N synthetic street scenes (io/synthetic.py, seeds
0..N-1) at ``DEFAULT_CONFIG``, in ONE process, the eager step
(``device_frame_step_packed_batched`` called op by op from Python) and the
compiled step (runtime/compiled.py: the same step captured once per B as
a CUDA graph and replayed) in ``TURNS`` turns: eager, graph, graph,
eager, so drift hits both alike. Per turn, at each B of ``BATCHES`` (the
frames B at a time) and for a B = 1 step on the cellgraph backend
(cell_capacity 128): device p50 (CUDA events around a step, 3 repeats
a batch), ms a frame (events around one pass over the frames, best of
3), and host us
to dispatch one step (the host clock around one call on an idle card, no
synchronise inside; median); and end-to-end ms a frame through
``ReplayStream`` on each route (the replay's wall time less one warmup
step). After the turns, for each case, one pass over the frames under
torch.profiler (``step_kernels``): CUDA kernels, device time and runtime
launch calls (``cudaLaunchKernel`` and the like against
``cudaGraphLaunch``) a step, and the idle share of that same pass (1 -
device time / the events around it); the graph's capture seconds and
pool against the eager step's own peak memory; and the ops of an eager
B = 8 step by device time.

Trees (``--trees``): each measurement runs in a process of its own with
the tree's root first on ``sys.path`` (so an older checkout of the port,
unpacked beside this one, measures its own code) through the entry points
every tree has: end to end through ``ReplayStream`` (each tree's default
route), host p50, device p50 of ``device_frame_step_packed`` (eager, 3
repeats a frame) and the kernels of one step; pair i runs the trees in
order when i is even and reversed when odd; the summary gives each
tree's median and interquartile range.

The script needs a CUDA GPU and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
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
ROUTES = ("eager", "graph")
BATCHES = (1, 4, 8)
TURNS = 2             # eager, graph, graph, eager
CELL_CAPACITY = 128   # the cellgraph case's cell_capacity (shipped: 64)


def step_kernels(run, steps: int = 1) -> dict:
    """torch.profiler's record of `run()`, which runs `steps` steps, a
    step: its CUDA ``kernels``, ``copies`` (memory copies and fills) and
    their summed device ms (``busy_ms``); the host's runtime calls that
    launched them, ``launch_calls`` (cudaLaunchKernel and the like) and
    ``graph_launches`` (cudaGraphLaunch); ``wall_ms``, the CUDA events
    around that same profiled run(); and ``idle``, 1 - busy_ms / wall_ms.
    run() is called once before the profile. The profile records CUDA
    activity only, and drops a first profiler step of one throwaway
    kernel: a profile can lose its first kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        prof.step()
    out = {"kernels": 0, "copies": 0, "busy_ms": 0.0, "launch_calls": 0,
           "graph_launches": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.key == "cudaGraphLaunch":
                out["graph_launches"] += e.count
            elif e.key.startswith(("cudaLaunch", "cuLaunch")):
                out["launch_calls"] += e.count
            continue
        copy = e.key.startswith(("Memcpy", "Memset"))
        out["copies" if copy else "kernels"] += e.count
        out["busy_ms"] += e.self_device_time_total / 1e3
    # a step; a count stays whole where every step ran the same
    out = {k: v // steps if isinstance(v, int) and v % steps == 0
           else v / steps for k, v in out.items()}
    out["wall_ms"] = start.elapsed_time(end) / steps
    out["idle"] = 1.0 - out["busy_ms"] / out["wall_ms"]
    return out


def top_ops(step, n: int = 8) -> str:
    """The n PyTorch ops whose kernels take the most device time in one
    call of `step`, with their share of the call's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0), reverse=True)
    total = sum(ms for ms, _, _ in ops) or 1.0
    return ", ".join(f"{key} {ms:.3f} ms ({100 * ms / total:.1f}%, {count} "
                     f"calls)" for ms, count, key in ops[:n])


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


def _replay_ms(stream, n_frames: int):
    """(end-to-end ms a frame less one warmup step, host p50 ms, results)
    of an n-frame ReplayStream run."""
    stream.warmup()                       # first run: kernel build, caches
    t0 = time.perf_counter()
    stream.warmup()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = list(stream.run(n_frames))  # run() warms up with one step
    run_s = time.perf_counter() - t0
    return ((run_s - warm_s) * 1e3 / n_frames,
            statistics.median(m.t_host_ms for _, m in results), results)


def _turn(step, batches, n_frames: int) -> dict:
    """One route's numbers at one B (module docstring)."""
    import torch
    dev = statistics.median(_event_ms(lambda: step(*b), 3) for b in batches)
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in batches:
            step(*b)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / n_frames)
    host = []
    for b in batches * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*b)
        host.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return {"device_p50_ms": dev, "ms_per_frame": best,
            "host_us": statistics.median(host)}


def _eager_peak_mib(step, batch) -> float:
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step(*batch)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**20


def route_turns(frames_dir: Path, n_frames: int) -> dict:
    """Eager against graph in turns in this process (module docstring);
    the frames are the first n_frames of frames_dir, and each B of
    ``BATCHES`` must divide n_frames."""
    import torch
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    from lidar_processing_tpu_torch.runtime.compiled import batched_step
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_packed_batched)
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream
    if not torch.cuda.is_available():
        raise RuntimeError("step_bench: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    cfg = DEFAULT_CONFIG
    configs = {"stixel": cfg, "cellgraph": cfg.replace(
        pipeline=dataclasses.replace(cfg.pipeline,
                                     clustering_backend="cellgraph",
                                     cell_capacity=CELL_CAPACITY))}
    streams = {route: ReplayStream(cfg, data_dir=str(frames_dir),
                                   device=dev, eager=route == "eager")
               for route in ROUTES}
    x, m = streams["eager"].xyz[:n_frames], streams["eager"].mask[:n_frames]
    cases = [("stixel", b) for b in BATCHES] + [("cellgraph", 1)]
    steps, groups, out = {}, {}, {}
    for case in cases:
        backend, b = case
        if n_frames % b:
            raise ValueError(f"step_bench: B={b} does not divide "
                             f"{n_frames} frames")
        steps[case] = {route: batched_step(
            device_frame_step_packed_batched, configs[backend], b, dev,
            route == "eager") for route in ROUTES}
        graph = steps[case]["graph"]
        groups[case] = [(x[lo:lo + b], m[lo:lo + b])
                        for lo in range(0, n_frames, b)]
        out[case] = {"capture_s": graph.capture_s,
                     "graph_pool_mib": graph.pool_bytes / 2**20,
                     "turns": {route: [] for route in ROUTES}}
    e2e = {route: [] for route in ROUTES}
    for i in range(TURNS):
        for route in (ROUTES if i % 2 == 0 else ROUTES[::-1]):
            for case in cases:
                out[case]["turns"][route].append(
                    _turn(steps[case][route], groups[case], n_frames))
            ms, host, results = _replay_ms(streams[route], n_frames)
            if any(r.overflow for _, r in results):
                raise AssertionError(f"step_bench: {route} replay overflowed")
            e2e[route].append({"e2e_ms": ms, "host_p50_ms": host})
    # the profiles after the turns: torch.profiler slows a host-bound step
    for case in cases:
        res = out[case]
        res["eager_peak_mib"] = _eager_peak_mib(steps[case]["eager"],
                                                groups[case][0])
        for route in ROUTES:
            prof = step_kernels(
                lambda: [steps[case][route](*b) for b in groups[case]],
                len(groups[case]))
            res[route] = {**prof,
                          **{k: statistics.median(t[k] for t in
                                                  res["turns"][route])
                             for k in ("device_p50_ms", "ms_per_frame",
                                       "host_us")}}
    big = max(BATCHES)
    top = top_ops(lambda: steps[("stixel", big)]["eager"](
        *groups[("stixel", big)][0]))
    return {"device": torch.cuda.get_device_name(dev), "frames": n_frames,
            "turns": TURNS,
            "cases": {f"{backend} B={b}": res
                      for (backend, b), res in out.items()},
            "e2e": e2e, f"top_ops_b{big}": top}


def format_routes(result: dict) -> str:
    """route_turns' result as lines of text (medians over the turns, each
    turn's number in brackets)."""
    def each(turns, key: str, fmt: str) -> str:
        return ", ".join(format(t[key], fmt) for t in turns)

    lines = []
    for name, res in result["cases"].items():
        for route in ROUTES:
            r, turns = res[route], res["turns"][route]
            lines.append(
                f"{name} {route}: device p50 {r['device_p50_ms']:.3f} ms "
                f"[{each(turns, 'device_p50_ms', '.3f')}], ms/frame "
                f"{r['ms_per_frame']:.3f} "
                f"[{each(turns, 'ms_per_frame', '.3f')}], host "
                f"{r['host_us']:.1f} us a dispatch "
                f"[{each(turns, 'host_us', '.1f')}], "
                f"{r['kernels']:.0f} kernels {r['busy_ms']:.3f} ms of "
                f"device time in {r['wall_ms']:.3f} ms by events (one "
                f"profiled pass, a step), idle {100 * r['idle']:.1f}%, "
                f"runtime launch calls {r['launch_calls']:.0f} + "
                f"{r['graph_launches']:.0f} graph")
        lines.append(
            f"{name}: capture {res['capture_s']:.3f} s, graph pool "
            f"{res['graph_pool_mib']:.0f} MiB against the eager step's own "
            f"peak {res['eager_peak_mib']:.0f} MiB")
    for route, runs in result["e2e"].items():
        lines.append(f"ReplayStream {route}: end to end "
                     f"[{each(runs, 'e2e_ms', '.2f')}] ms a frame, host p50 "
                     f"[{each(runs, 'host_p50_ms', '.2f')}] ms")
    for key, val in result.items():
        if key.startswith("top_ops"):
            lines.append(f"eager {key}: {val}")
    return "\n".join(lines)


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
    e2e, host, results = _replay_ms(stream, n_frames)
    dev_ms = [_event_ms(lambda: device_frame_step_packed(
        stream.xyz[f], stream.mask[f], stream.config), 3)
        for f in range(stream.num_frames)]
    out = step_kernels(lambda: device_frame_step_packed(
        stream.xyz[0], stream.mask[0], stream.config))
    out.update(device_p50_ms=statistics.median(dev_ms), host_p50_ms=host,
               e2e_ms=e2e, overflow=sum(m.overflow for _, m in results),
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


def _trees(trees, frames_dir: Path, n_frames: int, pairs: int) -> dict:
    runs = {str(t): [] for t in trees}
    for i in range(pairs):
        for tree in (trees if i % 2 == 0 else trees[::-1]):
            r = _run_one(tree, frames_dir, n_frames)
            runs[str(tree)].append(r)
            print(f"pair {i} {tree.name or tree}: "
                  + ", ".join(f"{k} {r[k]:.3f}" for k in _METRICS),
                  flush=True)
    result = {"frames": n_frames, "pairs": pairs, "runs": runs,
              "summary": {t: _summary(r) for t, r in runs.items()}}
    for tree, summ in result["summary"].items():
        print(f"{tree}: " + ", ".join(
            f"{k} {v['median']:.3f} [{v['q1']:.3f}-{v['q3']:.3f}]"
            for k, v in summ.items()), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=None)
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
    with tempfile.TemporaryDirectory() as tmp:
        sys.path.insert(0, str(_ROOT))
        write_frames(Path(tmp), args.frames)
        if args.trees:
            result = _trees([Path(t).resolve() for t in args.trees],
                            Path(tmp), args.frames, args.pairs)
        else:
            result = route_turns(Path(tmp), args.frames)
            print(format_routes(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
