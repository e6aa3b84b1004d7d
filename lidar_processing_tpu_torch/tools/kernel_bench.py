"""Kernel timing on the card, and probe kernels of several trees in turns.

    python -m lidar_processing_tpu_torch.tools.kernel_bench \\
        --trees PARENT_DIR . --turns 2 --out bench.json

Timing helpers, shared with chip_smoke.py: ``cuda_ms`` (CUDA events
around isolated calls), ``device_ms`` (torch.profiler's device time of a
call, retried until a profile keeps every call's kernel events),
``warm_ms`` (CUDA events around back-to-back calls), ``host_us`` (the
host clock a call, no synchronise in the loop), ``kernels_per_call``, and
``kernel_counts`` (the kernels one run ran, graph replays included).

The turns: the inputs are made once, then each tree measures its own
kernels on them in a fresh process, its root first on ``sys.path``, in
turns: the trees in order in even turns and reversed in odd ones
(parent, change, change, parent for two trees and two turns). Two sets:

- ``pairs``, the pair-minimum kernels (kernels/probe_pairs.py):
  tools/probe_mosaic.py's inputs (512 pairs, v <= 48, the (n/8, 24)
  stacked view), tools/probe_mosaic3.py's (8192 pairs, v <= 96, (n/128 +
  16, 384) rows; also with every pair's counts fixed, ``SWEEP``) and,
  where given, a frame's small ambiguous supernode pairs (v <= 96, a
  planar (3, n) array). Per input, "ready" times the kernel's wrapper on
  a layout made beforehand (a tree whose wrappers take x/y/z planes gets
  the planes), and "user" the probe's call as a user makes it
  (``mosaic_pairs`` / ``mosaic3_pairs``). Every tree must give the same
  bits: the pair minima are exact.
- ``slice``, the dynamic-slice kernel ``slice_sum(off, planes)``
  (kernels/probe_mosaic2.py) on tools/probe_mosaic2.py's inputs at n =
  1024, 16384 (the probe's) and 65536 terms of a (640, 384) array. Its
  f32 sum is taken in an order of each tree's own design, so the trees'
  bits differ by design: each tree must give the same bits on its own
  repeated calls (3 a process, and across its turns), and be within
  1e-5 of the sum of |terms| of the float64 sum.

Rank by device ms and warm ms: at these sizes events around one call
time the host's launch path. The script needs a CUDA GPU and never
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
HOST_CALLS = 1000       # calls a host-us or warm-ms measurement loops over
PROFILE_REPS = 10       # calls a device-ms profile records
PROFILE_TRIES = 5       # profiles device_ms takes at most


def cuda_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of fn() over `reps` isolated runs, after one
    warmup."""
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


def profiled(fn, reps: int, warmup: bool = True):
    """torch.profiler's key averages (CUDA activity) of `reps` calls of
    fn(), recorded after a warm-up step of as many calls whose events are
    dropped: a profile without one (`warmup` False) can lose its first
    kernel events. Raises while a CUDA graph of runtime/compiled.py is
    held in the process: such profiles then lost kernel events (H100,
    torch.profiler), so a count or time would be wrong."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    compiled = sys.modules.get("lidar_processing_tpu_torch.runtime.compiled")
    if compiled is not None and compiled.live_graphs():
        raise RuntimeError(f"profiled: {compiled.live_graphs()} CUDA graphs "
                           f"are held in this process; release them first")
    fn()
    torch.cuda.synchronize()
    if not warmup:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return prof.key_averages()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return prof.key_averages()


class DeviceMs(NamedTuple):
    """Device ms of one call (None: not measured), the device events the
    kept profile holds, and the events of every profile taken."""

    ms: Optional[float]
    kept: int
    counts: tuple


def device_ms(fn, reps: int = PROFILE_REPS,
              tries: int = PROFILE_TRIES) -> DeviceMs:
    """Device time of one fn() call: the CUDA work it ran, summed as
    torch.profiler records it, so the host's launch path between kernels
    is left out. A profile is kept only if it holds every call's events:
    each event name a positive multiple of `reps` times, and every name an
    earlier profile saw; else another profile is taken, `tries` in all."""
    import torch
    counts, names = [], set()
    for _ in range(tries):
        by_name, total_us = {}, 0.0
        for e in profiled(fn, reps):
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.key] = by_name.get(e.key, 0) + e.count
                total_us += e.self_device_time_total
        kept = sum(by_name.values())
        counts.append(kept)
        whole = (kept > 0 and names <= set(by_name)
                 and all(c % reps == 0 for c in by_name.values()))
        names |= set(by_name)
        if whole:
            return DeviceMs(total_us / 1e3 / reps, kept, tuple(counts))
    return DeviceMs(None, 0, tuple(counts))


def fmt_ms(ms) -> str:
    """A time in ms, or a DeviceMs with its events (or "not measured"
    with every profile's count)."""
    if isinstance(ms, DeviceMs):
        if ms.ms is None:
            return (f"not measured ({len(ms.counts)} profiles kept "
                    f"{', '.join(map(str, ms.counts))} events)")
        return f"{ms.ms:.6f} ms ({ms.kept} events)"
    return "not measured" if ms is None else f"{ms:.4f} ms"


def warm_ms(fn, calls: int = HOST_CALLS) -> float:
    """ms a call in a warm back-to-back run: CUDA events around `calls`
    calls (cuda_ms times one call from an idle card and a cold host)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds a call: the host clock over `calls` calls with no
    synchronise in the loop (one after it, outside the time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def kernels_per_call(fn, reps: int = 5, tries: int = 5) -> dict:
    """{kernel name: launches a call} of fn(), as torch.profiler records
    them (device work only): the most of `tries` profiles of `reps` calls
    each, should a profile still drop a share of its events."""
    import torch
    most = {}
    for _ in range(tries):
        for e in profiled(fn, reps):
            if e.device_type == torch.autograd.DeviceType.CUDA:
                most[e.key] = max(most.get(e.key, 0.0), e.count / reps)
    return most


def kernel_counts(run):
    """(run()'s result, {CUDA kernel name: launches}) of ONE call of run(),
    as torch.profiler records it (CUDA activity; a replayed CUDA graph's
    kernels are recorded node by node). A first profiler step, of one
    throwaway kernel, is dropped: a profile can lose its first kernel
    events. Profiling graph replays made later short profiles in the
    same process (``profiled``) lose more of their events (H100), so
    call this after those."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        out = run()
        torch.cuda.synchronize()
        prof.step()
    return out, {e.key: e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}


def launches_of(counts: dict, kernel: str) -> int:
    """The launches of the CUDA kernel named `kernel` in a {kernel name:
    launches} record."""
    from lidar_processing_tpu_torch.runtime.compiled import names_kernel
    return sum(n for key, n in counts.items() if names_kernel(key, kernel))


def timing(fn, calls: int = HOST_CALLS) -> dict:
    """kernel ms (isolated), device ms (DeviceMs), warm ms and host us of
    fn()."""
    return {"kernel": cuda_ms(fn), "device": device_ms(fn),
            "warm": warm_ms(fn, calls), "host": host_us(fn, calls)}


def fmt_timing(t: dict) -> str:
    return (f"kernel {t['kernel']:.4f} ms, device {fmt_ms(t['device'])}, "
            f"warm {t['warm']:.4f} ms, host {t['host']:.2f} us")


# ---- probe kernels in turns -------------------------------------------------

SWEEP = ((1, 1), (8, 1), (1, 96), (8, 96))   # (uc, vc) of the count sweep


def pair_inputs(frame_pairs=None) -> dict:
    """{set: (v_cap, layout rows, lanes, us, uc, vs, vc)} as numpy: the two
    JAX probes' inputs; probe_mosaic3's with every pair's counts set to
    each (uc, vc) of SWEEP (the same starts: what the loads and the
    window cost apart); and, given (xyz (n, 3), us, uc, vs, vc), a
    frame's pairs in the planar (1, 3n) layout."""
    from lidar_processing_tpu_torch.tools import probe_mosaic, probe_mosaic3
    _, stacked, *runs = probe_mosaic.make_inputs()
    _, rows, us, uc, vs, vc = probe_mosaic3.make_inputs()
    out = {"probe_mosaic": (48, stacked, 8, *runs),
           "probe_mosaic3": (96, rows, 128, us, uc, vs, vc)}
    for u_n, v_n in SWEEP:
        out[f"probe_mosaic3, counts {u_n}/{v_n}"] = (
            96, rows, 128, us, np.full_like(uc, u_n), vs,
            np.full_like(vc, v_n))
    if frame_pairs is not None:
        xyz, *fr = frame_pairs
        out["frame 0"] = (96, np.ascontiguousarray(xyz.T).reshape(1, -1),
                          xyz.shape[0], *fr)
    return out


SLICE_TERMS = (1024, 16384, 65536)


def slice_inputs() -> dict:
    """{set: (off, planes)} as numpy: tools/probe_mosaic2.py's seeded
    dynamic-slice inputs at each n of SLICE_TERMS."""
    from lidar_processing_tpu_torch.tools.probe_mosaic2 import (
        dyn_slice_inputs)
    return {f"slice_sum n={n}": dyn_slice_inputs(n) for n in SLICE_TERMS}


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _timed_call(f) -> dict:
    t = timing(f)
    t["device"] = t["device"]._asdict()
    t.update(kernels=sum(kernels_per_call(f).values()), digest=_digest(f()))
    return t


def measure(tree: Path, inputs: Path) -> dict:
    """One tree's kernels on the card (run in a fresh process): {set:
    {call: timing + kernels a call + output digest (+ value)}}."""
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA GPU")
    import lidar_processing_tpu_torch as port
    from lidar_processing_tpu_torch.kernels import probe_mosaic2 as m2
    from lidar_processing_tpu_torch.kernels import probe_pairs as pp
    if Path(port.__file__).resolve().parents[1] != tree.resolve():
        raise SystemExit(f"kernel_bench: imported {port.__file__}, not the "
                         f"port of {tree}")
    params = inspect.signature(pp.pair_min_d2_v48).parameters
    takes_layout = "points" in params
    dev = torch.device("cuda", 0)
    data = np.load(inputs, allow_pickle=False)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    out = {}
    for name in json.loads(str(data["sets"])):
        v_cap, lanes = (int(a) for a in data[f"{name}/meta"])
        rows = to(data[f"{name}/rows"])
        runs = [to(data[f"{name}/{k}"]) for k in ("us", "uc", "vs", "vc")]
        fn = pp.pair_min_d2_v48 if v_cap == 48 else pp.pair_min_d2_v96
        if takes_layout:
            calls = {"ready": lambda fn=fn, r=rows, ln=lanes, u=runs: fn(
                r, ln, *u)}
        else:
            planes = pp.row_planes(rows, lanes)
            calls = {"ready": lambda fn=fn, p=planes, u=runs: fn(*p, *u)}
        if name == "probe_mosaic":
            calls["user"] = lambda r=rows, u=runs: pp.mosaic_pairs(r, *u)
        elif name == "probe_mosaic3":
            calls["user"] = lambda r=rows, u=runs: pp.mosaic3_pairs(*u, r)
        out[name] = {call: _timed_call(f) for call, f in calls.items()}
    for name in json.loads(str(data["slices"])):
        off, planes = to(data[f"{name}/off"]), to(data[f"{name}/planes"])
        f = lambda o=off, p=planes: m2.slice_sum(o, p)  # noqa: E731
        digests = {_digest(f()) for _ in range(3)}
        if len(digests) != 1:
            raise AssertionError(f"kernel_bench: {tree} {name}: other bits "
                                 f"on repeated calls ({sorted(digests)})")
        t = _timed_call(f)
        t["value"] = float(f()[0, 0])
        out[name] = {"slice_sum": t}
    out["device"] = torch.cuda.get_device_name(0)
    return out


def _run_one(tree: Path, inputs: Path) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
           str(tree), "--inputs", str(inputs)]
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel_bench on {tree} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _fmt_call(t: dict) -> str:
    d = DeviceMs(**{**t["device"], "counts": tuple(t["device"]["counts"])})
    return (f"{fmt_timing({**t, 'device': d})}, {t['kernels']:g} kernels "
            f"a call")


def run_turns(trees, inputs: dict, slices: dict, turns: int = 2,
              log=print) -> dict:
    """Each tree's kernels on `inputs` (pair_inputs()) and `slices`
    (slice_inputs()) in turns; raises unless every tree gives the same
    pair minima, and each tree the same slice_sum bits in every run,
    within 1e-5 of the sum of |terms| of the float64 sum. Returns {"runs":
    {tree: [measure()]}, "mean": {tree: {set: {call: {metric: mean}}}}}."""
    trees = [Path(t).resolve() for t in trees]
    sets = [*inputs, *slices]
    runs = {str(t): [] for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "inputs.npz"
        arrays = {"sets": np.array(json.dumps(list(inputs))),
                  "slices": np.array(json.dumps(list(slices)))}
        for name, (v_cap, rows, lanes, *r) in inputs.items():
            arrays[f"{name}/meta"] = np.array([v_cap, lanes], np.int64)
            arrays[f"{name}/rows"] = np.ascontiguousarray(rows, np.float32)
            for k, a in zip(("us", "uc", "vs", "vc"), r):
                arrays[f"{name}/{k}"] = np.ascontiguousarray(a, np.int32)
        for name, (off, planes) in slices.items():
            arrays[f"{name}/off"] = np.ascontiguousarray(off, np.int32)
            arrays[f"{name}/planes"] = np.ascontiguousarray(planes,
                                                            np.float32)
        np.savez(path, **arrays)
        for i in range(turns):
            for tree in (trees if i % 2 == 0 else trees[::-1]):
                r = _run_one(tree, path)
                runs[str(tree)].append(r)
                for name in sets:
                    for call, t in r[name].items():
                        log(f"turn {i} {tree.name or tree} {name} {call}: "
                            f"{_fmt_call(t)}")
    digests = {(name, t["digest"]) for rs in runs.values() for r in rs
               for name in inputs for t in r[name].values()}
    if len(digests) != len(inputs):
        raise AssertionError(f"kernel_bench: the trees' pair minima differ "
                             f"({sorted(digests)})")
    for name, (off, planes) in slices.items():
        terms = planes[np.clip(off, 0, planes.shape[0] - 2)[:, None]
                       + np.arange(2)].astype(np.float64)
        tol = 1e-5 * np.abs(terms).sum()
        for tree, rs in runs.items():
            got = {(r[name]["slice_sum"]["digest"],
                    r[name]["slice_sum"]["value"])
                   for r in rs}
            if len(got) != 1 or abs(next(iter(got))[1] - terms.sum()) > tol:
                raise AssertionError(f"kernel_bench: {tree} {name}: {got} "
                                     f"against {terms.sum()} (tol {tol})")
            log(f"{Path(tree).name or tree} {name}: {next(iter(got))[1]!r} "
                f"in every run, float64 sum {float(terms.sum())!r}, tol "
                f"{tol:.4g}")
    mean = {}
    for tree, rs in runs.items():
        mean[tree] = {name: {call: {
            k: (None if None in vals else statistics.mean(vals))
            for k, vals in (("kernel", [r[name][call]["kernel"] for r in rs]),
                            ("device", [r[name][call]["device"]["ms"]
                                        for r in rs]),
                            ("warm", [r[name][call]["warm"] for r in rs]),
                            ("host", [r[name][call]["host"] for r in rs]),
                            ("kernels", [r[name][call]["kernels"]
                                         for r in rs]))}
            for call in rs[0][name]} for name in sets}
    for tree, m in mean.items():
        for name, calls in m.items():
            log(f"mean of {turns} turns, {Path(tree).name or tree} {name}: "
                + "; ".join(f"{call} kernel {v['kernel']:.4f}, device "
                            f"{fmt_ms(v['device'])}, warm {v['warm']:.4f} "
                            f"ms, host {v['host']:.2f} us, "
                            f"{v['kernels']:g} kernels"
                            for call, v in calls.items()))
    return {"runs": runs, "mean": mean}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[str(_ROOT)])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        res = measure(Path(args.measure), Path(args.inputs))
        print(json.dumps(res), flush=True)
        return res
    sys.path.insert(0, str(_ROOT))
    result = run_turns(args.trees, pair_inputs(), slice_inputs(),
                       args.turns)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
