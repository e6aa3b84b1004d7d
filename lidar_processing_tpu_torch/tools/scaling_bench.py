"""Scaling harness: frames/s against the number of shards on a mesh.

The port of the repo's root ``tools/scaling_bench.py``. It runs the data
axis (``sharded_batch_step``) at 1, 2, 4 and 8 shards and the 2 x 4
(data x space) mesh (``sharded_pipeline_2d``, segmentation and
clustering only) over the SAME fixed total work, and prints frames/s and
T(first)/T(n) for each, T(first) being the smallest shard count the ranks
divide (1 on one rank):

    python -m lidar_processing_tpu_torch.tools.scaling_bench \\
        [--frames-per-shard 2] [--reps 3] [--max-points 16384] \\
        [--device cuda] [--ranks N]
    torchrun --nproc-per-node N -m lidar_processing_tpu_torch.tools.scaling_bench

On the card each entry point replays its graph (runtime/compiled.py:
the program captured once per mesh layout, config and batch, its NCCL
collectives inside), as the JAX tool times its jitted calls; the first
call of each case, outside the timed repeats, captures it, and every
registered graph is released when a case ends. On the CPU the calls run
eagerly.

Read the layout line before the numbers. One rank holds every shard of an
axis and runs them as one batch, so on one card T(1)/T(n) measures the
mesh's overhead (the collectives, the reassembly), not chip scaling.
Several ranks come from ``torchrun`` or ``--ranks N`` (the bench's own
spawn): NCCL on cards (one rank a card), gloo with ``--device cpu``, where
the ranks share the host's cores, so their numbers are orchestration
time, never chip scaling. Runs on the card unless ``--device`` names
another (it raises without one).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG, SpatialConfig
from ..runtime import compiled

SHARDS = (1, 2, 4, 8)  # shard counts of the data axis, as the JAX tool's


def synth_frame(cap: int, seed: int) -> tuple:
    """Half the capacity of points: a flat ground square and 100-point
    boxes (the JAX tool's frame)."""
    rng = np.random.default_rng(seed)
    n_real = cap // 2
    n_box = min(2000, n_real // 4)
    n_box -= n_box % 100
    xyz = np.zeros((cap, 3), np.float32)
    g = rng.uniform([-40, -40, -1.8], [40, 40, -1.6], (n_real - n_box, 3))
    boxes = rng.uniform([-2, -2, -1.5], [2, 2, 0.5], (n_box, 3)) + np.repeat(
        rng.uniform(-30, 30, (n_box // 100, 3)) * [1, 1, 0], 100, axis=0)
    xyz[:n_real] = np.concatenate([g, boxes]).astype(np.float32)
    mask = np.zeros((cap,), bool)
    mask[:n_real] = True
    return xyz, mask


def bench_config(cap: int):
    """DEFAULT_CONFIG with the JAX tool's caps for `cap` points a frame."""
    pcfg = dataclasses.replace(
        DEFAULT_CONFIG.pipeline, max_points=cap, max_obstacle_points=cap,
        max_cells=cap, max_columns=cap // 2, max_supernodes=cap // 2,
        max_column_pairs=2 * cap, max_sn_pairs=2 * cap,
        max_live_edges=cap // 4, payload_large_points=cap)
    scfg = SpatialConfig(
        block_points=cap // 2, block_clusters=cap // 8,
        halo_points=cap // 8, block_cells=cap // 2,
        block_columns=cap // 4, block_supernodes=cap // 4,
        block_column_pairs=cap, block_sn_pairs=cap,
        block_live_edges=cap // 8)
    return DEFAULT_CONFIG.replace(pipeline=pcfg, spatial=scfg)


def _best_s(call, device, reps: int) -> float:
    """Best wall seconds of call() over `reps` runs after one warmup (on
    the card the capture of call()'s graph), each ended by a device sync
    (and a barrier across ranks); then every registered graph is
    released (``compiled.release_graphs``)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if dist.is_initialized():
            dist.barrier()
    call()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        sync()
        best = min(best, time.perf_counter() - t0)
    compiled.release_graphs()
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames-per-shard", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-points", type=int, default=16384)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1,
                    help="spawn this many ranks (NCCL on cards, gloo on "
                         "the CPU)")
    args = ap.parse_args(argv)
    if args.ranks > 1:
        return _spawned(args, argv)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        _init_from_torchrun(args.device)
    return _run(args)


def _spawned(args, argv) -> dict:
    """main() on args.ranks spawned ranks (each told --ranks 1: the last
    occurrence of an option wins); rank 0's result."""
    from ..parallel.launch import spawn
    cuda = torch.device(args.device).type == "cuda"
    if cuda and torch.cuda.device_count() < args.ranks:
        raise RuntimeError(f"{args.ranks} ranks need {args.ranks} cards, "
                           f"have {torch.cuda.device_count()}")
    argv = list(sys.argv[1:] if argv is None else argv) + ["--ranks", "1"]
    with tempfile.TemporaryDirectory() as rdzv:
        return spawn(main, args.ranks, argv, rdzv_dir=rdzv,
                     backend="nccl" if cuda else "gloo", timeout_s=1800)[0]


def _init_from_torchrun(device: str) -> None:
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")


def _run(args) -> dict:
    from ..parallel.sharded import (make_mesh, make_mesh_2d,
                                    sharded_batch_step, sharded_pipeline_2d)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("scaling_bench runs on a CUDA GPU and none is "
                               "available; pass --device cpu")
        device = torch.device("cuda", torch.cuda.current_device())
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    backend = dist.get_backend() if dist.is_initialized() else "none"
    cap = args.max_points
    cfg = bench_config(cap)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    say(f"layout: {world} rank(s), process group backend {backend}, "
        f"{device} ({name}); points/frame={cap}. A rank runs all of its "
        f"shards as ONE batch: with one rank, T(first)/T(n) is the mesh's "
        f"overhead, not scaling; ranks on the CPU share the host's cores")
    # FIXED total work across shard counts: T(first)/T(n) compares the
    # same frames
    b_total = args.frames_per_shard * max(SHARDS)
    frames = [synth_frame(cap, seed=i) for i in range(b_total)]
    xs = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    ms = torch.from_numpy(np.stack([f[1] for f in frames])).to(device)
    out = {"layout": {"ranks": world, "backend": backend,
                      "device": str(device), "name": name},
           "data": {}}
    for n in SHARDS:
        if n % world:
            say(f"data axis: {n} shards do not divide over {world} ranks, "
                f"skipped")
            continue
        mesh = make_mesh(n, "data", device=device)
        best = _best_s(lambda: sharded_batch_step(mesh, xs, ms, cfg), device,
                       args.reps)
        out["data"][n] = best
        first = min(out["data"])
        say(f"data axis: {b_total} frames on {n} shards ({world} rank(s) x "
            f"{n // world} shards): {b_total / best:8.2f} fps "
            f"({best * 1e3 / b_total:7.2f} ms/frame)  T({first})/T({n}) = "
            f"{out['data'][first] / best * 100:5.1f}%")
    mesh2 = make_mesh_2d(2, 4, device=device)
    best = _best_s(lambda: sharded_pipeline_2d(mesh2, xs[:2], ms[:2], cfg),
                   device, args.reps)
    out["mesh_2d"] = best
    say(f"2-D mesh (2 data x 4 space shards; data {mesh2.ranks['data']} x "
        f"space {mesh2.ranks['space']} rank(s)), 2 frames: {2 / best:8.2f} "
        f"fps ({best * 1e3 / 2:7.2f} ms/frame) [seg+cluster only]")
    return out


if __name__ == "__main__":
    main()
