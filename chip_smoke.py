#!/usr/bin/env python3
"""Drive the PyTorch port of the engine once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script never exits 0 after one):

  1. device check: a CUDA device must be present (no CPU fallback);
  2. build: compile lidar_processing_tpu_torch/csrc/*.cu with nvcc for
     sm_90a into lidar_processing_tpu_torch/build/;
  3. kernels vs their plain PyTorch twins on the card, at the shapes the
     main path gives them: min_d2 at all 12 stixel tier shapes (<= 4 ULP),
     union-find on random graphs (equal), with CUDA-event times of both;
  4. main path: 8 full-size synthetic street scenes (seeds 0-7) written as
     PCD files, replayed through ReplayStream on the card; every frame must
     report overflow 0, one outline per cluster and a cluster count in the
     scene's target range, and both kernels must have been launched the
     expected number of times by that run;
  5. CUDA vs CPU: frame 0's cluster_fused on the card (kernels) and on the
     CPU (twins) from the same sorted inputs must agree bit for bit, and
     the two segmentations within max(2, n // 1000) labels; a small
     scene's cluster labels on the card equal an independent exact
     radius-graph connected-components reference (scipy);
  6. no host syncs inside one device step (torch's sync debug mode);
  7. per-frame device / host / end-to-end times; no jax imported.

Prints the kernels' JSON record, the card's name and power limit, and, as
its last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
N_FRAMES = 8
WARMUP_FRAMES = 1          # ReplayStream.run() warms up with one step
CLUSTER_RANGE = (300, 600)  # io/synthetic.py full-size scene targets


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of fn() over `reps` runs, after one warmup."""
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


def ulp_diff(a, b) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def check_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA GPU and has no CPU mode")
    import lidar_processing_tpu_torch as port
    pkg_dir = Path(port.__file__).resolve().parent.parent
    if pkg_dir != HERE:
        raise SystemExit(f"chip_smoke: imported the port from {pkg_dir}, "
                         f"not from this checkout ({HERE})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return torch.device("cuda", 0), smi


def build_kernels():
    from lidar_processing_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    log(f"build: {info.path.name} from {[p.name for p in _build._sources()]}"
        f" flags {' '.join(_build.NVCC_FLAGS)} in {secs:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "smem" in line or "error" in line:
            log(f"  nvcc: {line.strip()}")
    return secs


def min_d2_inputs(rng, p, wu, wv, device):
    import torch
    pts_u = rng.uniform(-30, 30, (p, wu, 3)).astype(np.float32)
    pts_v = rng.uniform(-30, 30, (p, wv, 3)).astype(np.float32)
    for q in range(0, p, max(1, p // 7)):       # masked suffixes
        pts_u[q, wu - (q % wu):] = 1.0e9
        pts_v[q, wv - (q % wv):] = -1.0e9
    return tuple(torch.from_numpy(np.ascontiguousarray(pts[:, :, a]))
                 .to(device) for pts in (pts_u, pts_v) for a in range(3))


def check_min_d2(device):
    from lidar_processing_tpu_torch.kernels.min_d2 import (min_d2_planar,
                                                           min_d2_planar_ref)
    from lidar_processing_tpu_torch.ops import stixel as sx
    rng = np.random.default_rng(0)
    worst, max_abs, ms, plain_ms = 0, 0.0, 0.0, 0.0
    for u_cap, v_cap, slots in sx._TIERS_INTRA + sx._TIERS_SNP:
        p, wu, wv = slots, u_cap + 8, v_cap + 32
        args = min_d2_inputs(rng, p, wu, wv, device)
        got = min_d2_planar(*args).cpu().numpy()
        want = min_d2_planar_ref(*args).cpu().numpy()
        ulp = ulp_diff(got, want)
        if got.shape != (p,) or ulp > 4:
            raise AssertionError(f"min_d2 ({p},{wu},{wv}): {ulp} ULP")
        worst = max(worst, ulp)
        max_abs = max(max_abs, float(np.abs(got - want).max(initial=0.0)))
        t_k = cuda_ms(lambda: min_d2_planar(*args))
        t_p = cuda_ms(lambda: min_d2_planar_ref(*args))
        ms += t_k
        plain_ms += t_p
        log(f"min_d2 ({p:5d},{wu:3d},{wv:3d}): {ulp} ULP, kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms")
    log(f"min_d2: 12 tier shapes, max {worst} ULP; per-frame sum kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    return worst, max_abs, ms, plain_ms


def random_graph(rng, s_cap, ec, n_edges, device):
    """Edges sorted by packed (u, v) like the pipeline's edge list."""
    import torch
    eu = rng.integers(0, s_cap, ec)
    ev = np.minimum(s_cap - 1, eu + rng.integers(1, 40, ec))
    order = np.lexsort((ev[:n_edges], eu[:n_edges]))
    eu[:n_edges], ev[:n_edges] = eu[:n_edges][order], ev[:n_edges][order]
    eu[n_edges:], ev[n_edges:] = 0, 0
    to = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)  # noqa
    return to(eu), to(ev), torch.tensor(n_edges, dtype=torch.int32,
                                        device=device)


def check_union_find(device):
    from lidar_processing_tpu_torch.kernels.union_find import (cc_labels,
                                                               cc_labels_ref)
    rng = np.random.default_rng(1)
    ec = 32768
    max_abs = 0
    for s_cap, n_edges in ((128, 0), (128, 300), (2048, 4000),
                           (2048, 32768), (10240, 0), (10240, 20000),
                           (10240, 32768)):
        g = random_graph(rng, s_cap, ec, n_edges, device)
        got = cc_labels(*g, s_cap).cpu().numpy()
        want = cc_labels_ref(*g, s_cap).cpu().numpy()
        if got.shape != (s_cap,) or not np.array_equal(got, want):
            raise AssertionError(f"union_find s_cap={s_cap} n_edges="
                                 f"{n_edges}: {np.sum(got != want)} differ")
        max_abs = max(max_abs, int(np.abs(got - want).max(initial=0)))
        log(f"union_find s_cap={s_cap:5d} n_edges={n_edges:5d}: equal "
            f"({len(np.unique(got))} components)")
    # timed at the main path's shape: s_cap = max_supernodes, 32768 edge
    # slots, ~20k live edges (the KITTI maximum the caps were sized for)
    g = random_graph(rng, 10240, ec, 20000, device)
    ms = cuda_ms(lambda: cc_labels(*g, 10240))
    plain_ms = cuda_ms(lambda: cc_labels_ref(*g, 10240))
    log(f"union_find (10240 nodes, 20000 edges): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return max_abs, ms, plain_ms


def write_frames(tmp: Path) -> None:
    from lidar_processing_tpu_torch.io.pcd import write_pcd_xyzi
    from lidar_processing_tpu_torch.io.synthetic import street_scene
    t0 = time.perf_counter()
    sizes = []
    for seed in range(N_FRAMES):
        xyz, inten = street_scene(seed)
        write_pcd_xyzi(tmp / f"{seed:06d}.pcd", xyz, inten)
        sizes.append(xyz.shape[0])
    log(f"frames: {N_FRAMES} synthetic street scenes (seeds 0-"
        f"{N_FRAMES - 1}), {min(sizes)}-{max(sizes)} points, written in "
        f"{time.perf_counter() - t0:.1f} s")


def run_main_path(tmp: Path, device):
    """ReplayStream over the frames; returns (stream, metrics, launches,
    end-to-end ms/frame)."""
    import torch
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    from lidar_processing_tpu_torch.kernels.min_d2 import min_d2_planar
    from lidar_processing_tpu_torch.kernels.union_find import cc_labels
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream

    stream = ReplayStream(DEFAULT_CONFIG, data_dir=str(tmp), device=device)
    stream.warmup()                       # first run: kernel build/caches
    t0 = time.perf_counter()
    stream.warmup()
    warm_s = time.perf_counter() - t0

    min_d2_planar.launches = 0
    cc_labels.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    results = list(stream.run(N_FRAMES))  # run() warms up with one step
    run_s = time.perf_counter() - t0
    launches = {"min_d2": min_d2_planar.launches,
                "union_find": cc_labels.launches}
    e2e_ms = (run_s - warm_s) * 1e3 / N_FRAMES

    lo, hi = CLUSTER_RANGE
    for out, m in results:
        log(f"frame {m.frame_id}: {m.ground_points} ground, "
            f"{m.obstacle_points} obstacle, {m.num_clusters} clusters, "
            f"{m.num_outlines} outlines, overflow {m.overflow}, "
            f"dispatch {m.t_dispatch_ms:.2f} ms, host {m.t_host_ms:.1f} ms")
        if m.overflow != 0:
            raise AssertionError(f"frame {m.frame_id}: overflow {m.overflow}")
        if m.num_outlines != m.num_clusters:
            raise AssertionError(f"frame {m.frame_id}: {m.num_outlines} "
                                 f"outlines for {m.num_clusters} clusters")
        if not lo <= m.num_clusters <= hi:
            raise AssertionError(f"frame {m.frame_id}: {m.num_clusters} "
                                 f"clusters outside {CLUSTER_RANGE}")
        n = len(out.seg_labels)
        if out.cluster_labels.shape != (n,) or not all(
                np.isfinite(o).all() and o.shape[1:] == (2,)
                for o in out.outlines):
            raise AssertionError(f"frame {m.frame_id}: malformed outputs")
    steps = N_FRAMES + WARMUP_FRAMES
    want = {"min_d2": 12 * steps, "union_find": steps}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    log(f"main path: {N_FRAMES} frames + {WARMUP_FRAMES} warmup through "
        f"ReplayStream; launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MiB")
    return stream, results, launches, e2e_ms


def check_cuda_vs_cpu(stream) -> int:
    """Frame 0: cluster_fused on the card (kernels) and on the CPU (twins)
    from the same sorted inputs must agree bit for bit."""
    import torch
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG as cfg
    from lidar_processing_tpu_torch.ops.segmentation import (
        gpf_segment, gpf_segment_sorted)
    from lidar_processing_tpu_torch.ops.stixel import cluster_fused
    from lidar_processing_tpu_torch.types import SEG_OBSTACLE

    xyz, mask = stream.xyz[0], stream.mask[0]
    ss = gpf_segment_sorted(xyz, mask, cfg.segmentation)
    args = (ss.xyz, ss.valid & (ss.labels == SEG_OBSTACLE), ss.valid,
            ss.orig, ss.labels)
    on_gpu = cluster_fused(*args, cfg.clustering, cfg.pipeline)
    on_cpu = cluster_fused(*(a.cpu() for a in args), cfg.clustering,
                           cfg.pipeline)
    for name, a, b in (
            ("labels", on_gpu.result.labels, on_cpu.result.labels),
            ("num_clusters", on_gpu.result.num_clusters,
             on_cpu.result.num_clusters),
            ("overflow", on_gpu.result.overflow, on_cpu.result.overflow),
            ("seg_labels", on_gpu.seg_labels, on_cpu.seg_labels),
            ("sorted_xyz", on_gpu.sorted_xyz, on_cpu.sorted_xyz),
            ("sorted_label", on_gpu.sorted_label, on_cpu.sorted_label),
            ("sorted_orig", on_gpu.sorted_orig, on_cpu.sorted_orig)):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            raise AssertionError(f"cluster_fused.{name}: CUDA and CPU differ")
    n = int(stream.counts[0])
    seg_gpu = gpf_segment(xyz, mask, cfg.segmentation).labels.cpu()[:n]
    seg_cpu = gpf_segment(xyz.cpu(), mask.cpu(), cfg.segmentation).labels[:n]
    diff = int((seg_gpu != seg_cpu).sum())
    if diff > max(2, n // 1000):
        raise AssertionError(f"segmentation: {diff} of {n} labels differ "
                             f"between CUDA and CPU")
    log(f"cluster_fused frame 0: CUDA (kernels) == CPU (twins) bit for bit "
        f"({int(on_gpu.result.num_clusters)} clusters); segmentation "
        f"CUDA vs CPU: {diff} of {n} labels differ")
    return diff


def check_against_radius_cc(device) -> int:
    """A small scene through the device step on the card: its cluster
    labels must equal an independent reference — exact connected
    components of the d <= sqrt(distance_squared) graph over the obstacle
    points (scipy), size-filtered and numbered by min point index."""
    import dataclasses
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
    from lidar_processing_tpu_torch.runtime.pipeline import device_frame_step
    from lidar_processing_tpu_torch.types import (CLUSTER_INVALID,
                                                  CLUSTER_UNDEFINED)

    cfg = DEFAULT_CONFIG.replace(pipeline=dataclasses.replace(
        DEFAULT_CONFIG.pipeline, max_points=4096, max_obstacle_points=4096,
        max_cells=2048, max_columns=1024, max_supernodes=2048,
        max_column_pairs=8192, max_sn_pairs=8192))
    xyz, _ = street_scene(0, "small")
    x, m = pad_frame(xyz, 4096)
    fr = device_frame_step(torch.from_numpy(x).to(device),
                           torch.from_numpy(m).to(device), cfg)
    n = xyz.shape[0]
    seg = fr.seg.labels.cpu().numpy()[:n]
    got = fr.clustering.labels.cpu().numpy()[:n]
    obst = np.flatnonzero(seg == 2)
    pairs = cKDTree(xyz[obst].astype(np.float64)).query_pairs(
        np.sqrt(cfg.clustering.distance_squared), output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                       shape=(len(obst), len(obst)))
    _, comp = connected_components(graph, directed=False)
    want = np.full(n, CLUSTER_UNDEFINED, np.int32)
    sizes = np.bincount(comp)
    first = np.full(len(sizes), n)
    np.minimum.at(first, comp, obst)
    keep = sizes >= cfg.clustering.min_cluster_size
    rank = np.full(len(sizes), CLUSTER_INVALID)
    rank[keep] = np.argsort(np.argsort(first[keep]))
    want[obst] = rank[comp]
    if not np.array_equal(got, want):
        raise AssertionError(f"radius-CC reference: {np.sum(got != want)} "
                             f"labels differ")
    log(f"small scene on the card: cluster labels == exact radius-CC "
        f"reference ({int(keep.sum())} clusters, {len(obst)} obstacles)")
    return int(keep.sum())


def count_host_syncs(stream) -> int:
    """Host syncs inside one device step, as torch's sync debug mode
    reports them; the fixed-shape step must have none."""
    import warnings
    import torch
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_packed)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            device_frame_step_packed(stream.xyz[0], stream.mask[0],
                                     stream.config)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    log(f"host syncs in one device step: {len(syncs)}"
        + "".join(f"\n  at {m}" for m in sorted(set(syncs))))
    if syncs:
        raise AssertionError("the device step waits on the card")
    return len(syncs)


def time_frames(stream, results, device):
    """p50 device ms/frame (CUDA events around the step) and p50 host
    ms/frame (the stream's host decode + outlines)."""
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_packed)
    dev_ms = []
    for fid in range(stream.num_frames):
        dev_ms.append(cuda_ms(lambda: device_frame_step_packed(
            stream.xyz[fid], stream.mask[fid], stream.config), reps=3))
    host_ms = [m.t_host_ms for _, m in results]
    return statistics.median(dev_ms), statistics.median(host_ms)


def main() -> None:
    device, smi = check_device()
    build_s = build_kernels()
    d2_ulp, d2_err, d2_ms, d2_plain = check_min_d2(device)
    uf_err, uf_ms, uf_plain = check_union_find(device)

    with tempfile.TemporaryDirectory() as tmp:
        write_frames(Path(tmp))
        stream, results, launches, e2e_ms = run_main_path(Path(tmp), device)
    check_cuda_vs_cpu(stream)
    check_against_radius_cc(device)
    count_host_syncs(stream)
    dev_ms, host_ms = time_frames(stream, results, device)
    log(f"per frame ({smi}): device p50 {dev_ms:.3f} ms, host p50 "
        f"{host_ms:.1f} ms, end to end {e2e_ms:.1f} ms "
        f"(build {build_s:.1f} s)")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    import torch
    csrc = "lidar_processing_tpu_torch/csrc"
    record = {"kernels": [
        {"name": "min_d2", "route": "cuda", "source": f"{csrc}/min_d2.cu",
         "replaces": "lidar_processing_tpu/kernels/min_d2.py:48",
         "launches": launches["min_d2"], "max_abs_err": d2_err,
         "ms": d2_ms, "plain_ms": d2_plain},
        {"name": "union_find", "route": "cuda",
         "source": f"{csrc}/union_find.cu",
         "replaces": "lidar_processing_tpu/kernels/union_find.py:31",
         "launches": launches["union_find"], "max_abs_err": uf_err,
         "ms": uf_ms, "plain_ms": uf_plain},
    ]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
