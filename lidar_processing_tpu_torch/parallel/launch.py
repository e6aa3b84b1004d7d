"""Ranks as processes: run one job on every rank of a fresh process group.

``spawn(job, world_size, *args, rdzv_dir=...)`` starts `world_size`
processes (the ``spawn`` start method: each starts from a fresh import,
so `job` must be a module-level function of a module that imports no
jax), joins them in one ``torch.distributed`` process group through a
file rendezvous in `rdzv_dir` (no port to collide on), runs ``job(*args)``
on every rank with one CPU thread each, and returns the ranks' results in
rank order. The backend is gloo on the CPU, NCCL on cards (rank r on
card r % device_count; NCCL refuses two ranks on one card). A rank that
raises fails the call with its traceback; a rank that does not answer
within `timeout_s` fails it too, and every process still running is
killed, so a hung collective never hangs the caller.

``run_entry_points`` is a job: it builds a mesh per call and runs a
parallel entry point on it, numpy in and numpy out (the tests' layouts);
``run_on_graphs`` also reports the graphs those calls captured.
"""

from __future__ import annotations

import datetime
import queue
import time
import traceback
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..runtime import compiled


def _rank_entry(rank: int, world_size: int, init_method: str, backend: str,
                timeout_s: float, job, args, results) -> None:
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, job(*args)))
        finally:
            # graphs that captured this group's collectives go first
            compiled.release_graphs()
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(job, world_size: int, *args, rdzv_dir, backend: str = "gloo",
          timeout_s: float = 120.0) -> list:
    """``job(*args)`` on `world_size` ranks; their results in rank order
    (each must pickle: numpy, not tensors). See the module docstring."""
    rdzv = Path(rdzv_dir) / f"rdzv-{time.time_ns()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True, args=(
        rank, world_size, f"file://{rdzv}", backend, timeout_s, job, args,
        results)) for rank in range(world_size)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise TimeoutError(f"{world_size - len(out)} of "
                                   f"{world_size} ranks did not answer "
                                   f"within {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[rank] for rank in range(world_size)]


def _numpy(tree):
    """A result tree with every tensor as a numpy array (NamedTuples as
    tuples of their fields)."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, tuple):
        return tuple(_numpy(t) for t in tree)
    return tree


def run_entry_points(device: str, calls: Sequence[tuple],
                     repeats: int = 1) -> list:
    """A job: for each (entry point, mesh shape, args) of `calls`, a mesh
    over this process group (``make_mesh(n, axis)`` for a shape {axis:
    n}, ``make_mesh_2d`` for {"data": ., "space": .}) on `device` and
    ``entry_point(mesh, *args)`` on numpy args, `repeats` times on that
    mesh (on the card the first call captures the program's graph, the
    others replay it), each result as numpy, read after the call's last
    repeat; the results in call order, a call's repeats together. The
    entry points are module-level functions of the port (they pickle by
    reference)."""
    from .mesh import make_mesh, make_mesh_2d
    out = []
    for entry, shape, args in calls:
        if len(shape) == 2:
            mesh = make_mesh_2d(shape["data"], shape["space"], device)
        else:
            (axis, n), = shape.items()
            mesh = make_mesh(n, axis, device)
        args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                for a in args]
        results = [entry(mesh, *args) for _ in range(repeats)]
        out.extend(_numpy(r) for r in results)
    return out


def run_on_graphs(device: str, calls: Sequence[tuple],
                  repeats: int = 2) -> tuple:
    """A job: ``run_entry_points(device, calls, repeats)`` and the graphs
    those calls registered (runtime/compiled.py), which it then releases:
    a list of {"name": "<entry point> <shards>", "frames": (B, N),
    "tier_min_d2": nodes, "union_find": nodes, "nccl": NCCL kernel nodes,
    "replays": replays}."""
    from .mesh import program_name
    out = run_entry_points(device, calls, repeats)
    graphs = [{
        "name": program_name(key), "frames": key[2:4],
        "tier_min_d2": step.kernel_nodes("tier_min_d2_kernel"),
        "union_find": step.kernel_nodes("union_find_kernel"),
        "nccl": step.nccl_nodes(), "replays": step.replays}
        for key, step in compiled.programs().items()]
    compiled.release_graphs()
    return out, graphs
