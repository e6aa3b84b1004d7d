#!/usr/bin/env python3
"""Drive the PyTorch port of the engine once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script never exits 0 after one):

  1. device check: a CUDA device must be present (no CPU fallback);
  2. build: compile lidar_processing_tpu_torch/csrc/*.cu with nvcc for
     sm_90a (one nvcc per source, all at once) into one library under
     lidar_processing_tpu_torch/build/, and, at the same time, the host
     C++ module (native/lidar_native.cpp) with g++;
  3. main path, first, so that no measurement below slows its host
     stage: 8 full-size synthetic street scenes (seeds 0-7) written as PCD
     files, replayed through ReplayStream on the card, on its compiled
     step (runtime/compiled.py: the packed step captured once as a CUDA
     graph and replayed a frame); every frame must report overflow 0, one
     outline per cluster and a cluster count in the scene's target range;
     the wrappers' counts, set to 0 before the stream is built and read
     after its run, must hold the warm-up steps' and the capture's
     launches and nothing more (no step ran eagerly after the capture);
     the graph the run replayed must hold tier_min_d2_kernel twice (one
     per tier table), union_find_kernel once and min_d2_kernel never
     (its kernel nodes, read from CUDA's DOT print of that graph), and
     the run must have replayed it once a step; nodes x replays are the
     main path's launches in the kernels line; the native
     chi_hulls_batch must be called once a frame; the graph must hold
     globaltimer_stamp_kernel five times (a stamp a stage boundary, the
     Python count five a warm-up step and the capture plus the clock
     calibrations'), every frame's four device stages must take some
     time with its first and last stamps, mapped onto the host clock,
     inside its dispatch's start and its device wait's end (within the
     calibration's error and 20 us), and frame 0's stats row, replayed
     again, must hold its rising stamps in columns 0-4 inside the host's
     bracket and the run's counters, equal to cluster_debug's;
  4. CUDA vs CPU: frame 0's cluster_fused on the card (kernels) and on the
     CPU (twins) from the same sorted inputs must agree bit for bit, and
     the two segmentations within max(2, n // 1000) labels; a small
     scene's cluster labels on the card equal an independent exact
     radius-graph connected-components reference (scipy);
  5. no host syncs inside one device step (torch's sync debug mode);
  6. per-frame device (the stream's compiled step) / host / end-to-end
     times;
  7. the batched step (device_frame_step_batched) over the 8 frames at
     B = 1, 4 and 8: every frame's FrameResult leaves and payload words
     at B = 4 and 8 equal its B = 1 results bit for bit; each batched
     step launched tier_min_d2 twice and union_find once, whatever B is
     (counts set to 0 before each B and read after); ms per frame at each
     B (CUDA events around the batched calls, best of 3 passes) and the
     peak device memory of one step at each B; the B = 8 step's kernel
     calls are recorded for phase 14;
  8. host stage and entry points: frame 0's large-cluster outlines native
     vs the scipy chain (chamfer < 0.05 each), a broken native build
     raising instead of reaching scipy, host p50 and end to end of the 8
     frames through the native and the scipy route, a stage-timed replay,
     a replay paced at 10 Hz (its dispatch p50 and deadline misses, as
     ``run --realtime`` reports them), and the CLI's run (with an
     export), golden (2 frames, must pass) and
     bench (B = 1, 4 and 8; its JSON line printed), each on the compiled
     step; the stage-timed replay runs on its two stage graphs (B = 1
     segment_stage and cluster_stage, the latter holding
     {tier_min_d2_kernel: 2, union_find_kernel: 1} nodes, the former
     none), with an eager stream's stage times printed beside them;
  8b. the compiled step (runtime/compiled.py) against the eager step: for
     B = 1, 4 and 8 on the stixel backend and B = 1 and 8 on the
     cellgraph backend (cell_capacity 128), a CompiledStep of the batched
     step and its payloads over frames 0-7: every replay's FrameResult
     leaves and payload words equal the eager step's bit for bit; each
     graph holds {tier_min_d2_kernel: 2, union_find_kernel: 1,
     min_d2_kernel: 0} kernel nodes (stixel) or none of them (cellgraph),
     and its replays add nothing to the wrappers' counts; each graph is
     released after its check, and so is the main path's (ReplayStream
     .release(); captured again in phase 15b): with graphs in the
     process, torch.profiler kept fewer of the probes' kernel events, so
     kernel_bench.profiled refuses to run while one is held, and no graph
     replay is profiled before the probes (that too cost them events);
  9. the cellgraph backend and the single-device ops, at DEFAULT_CONFIG
     full width with clustering_backend "cellgraph" and cell_capacity 128:
     the 8 frames through ReplayStream (overflow 0, cluster labels and
     counts equal to the stixel stream's bit for bit, no stixel kernel
     launched; each frame's overflow at the shipped cell_capacity 64
     printed); the small scene against the radius-CC reference; frame
     0's cluster and label_runs CUDA == CPU; a B = 8 step == eight B = 1
     steps; 0 host syncs in a cellgraph step; its kernels and device time
     (and that time by op), device p50 at B = 1, ms per frame at B = 8 and
     peak memory; run_frame
     == device_frame_step + host_outputs; NeighborIndex over frame 0
     (k_nearest k = 16, radius_search at distance_squared, capacity 256,
     4096 queries) CUDA == CPU, timed; seg_scan_min / seg_scan_max CUDA ==
     CPU; tools/measure_caps (8 frames), tier_hist (2) and profile_stages
     (8, with sub-stages) run to their end;
  10. sharded and spatial (parallel/), on one NCCL rank (world size 1) at
     DEFAULT_CONFIG full width over the 8 frames, every public entry point
     on its graph (runtime/compiled.py's registry: captured at its first
     call, with its collectives inside, on meshes built anew each call):
     their densest x-band at 4 and 8 bands printed; cluster_spatial at 8
     and 4 shards on each frame's obstacle mask == its eager body
     (_cluster_bands) and == stixel.cluster bit for bit, overflow 0;
     gpf_spatial and device_frame_step_spatial at 8 shards with
     block_points 131072 (the step distributes every point) == their
     eager bodies bit for bit, seg within max(2, n // 1000) labels of
     device_frame_step, clustering == stixel.cluster of its own obstacle
     mask, overflow and hull_overflow 0, n_small + n_large ==
     num_clusters; cluster_spatial_2d on a 2 x 4 mesh (frames 0-1) ==
     stixel.cluster; sharded_batch_step at B = 8 ==
     device_frame_step_batched leaf for leaf; sharded_pipeline_2d on a
     2 x 4 mesh (frames 0-1) == gpf_segment + stixel.cluster, each also
     == its eager body; every graph that clusters holds
     {tier_min_d2_kernel: 2, union_find_kernel: 1} kernel nodes
     (gpf_spatial's none), the wrappers' counts (set to 0 before the
     drive, read after) hold only the warm-up steps' and the captures'
     launches, and the graphs' nodes x replays are the launches that join
     rows 1-2 of the JSON line; each graph's NCCL kernel nodes, node
     kinds, pool and capture seconds printed; frame 0's 8-band kernel
     calls (from the eager body) against the twins bit for bit; 0 host
     syncs in a cluster_spatial eager body and replay; graph against
     graph p50 (CUDA events) of cluster_spatial (4, 8 shards) against the
     clustering stage's graph (stixel.cluster) and of the spatial step
     against the main path's B = 1 graph, each route's eager p50, eager
     kernels, device time and peak memory beside it; the scaling bench's
     main() on this one rank (on graphs); then every graph is released
     (live_graphs() 0 before the knife-edge and probe phases);
  11. knife edge: tools/knife_cases.py's KNIFE rows and its crafted pair
     per d² screen (cell gap and rep at k = 1, 2; supernode gap and the
     four rep probes; the exact tests; the cellgraph's; the halo test)
     through stixel ``cluster``, the cellgraph ``cluster`` (cell_capacity
     128) and ``cluster_spatial`` at 2 bands (on the card its graph,
     released after), on the card and on the CPU: labels CUDA == CPU bit
     for bit and every verdict the stored one (the
     JAX package's on the CPU; the one stored exception is its bands' k = 1
     cell rep screen, whose rounding XLA picks by the table's size);
  12. torch.profiler's count of CUDA kernels in one device step at B = 1
     (at most 2995) and in one batched step at B = 8;
  13. synthetic frame 0 at DEFAULT_CONFIG through cluster_debug, recording
     the two tier_min_d2 calls of its step and its edge list;
  14. kernels vs their plain PyTorch twins on the card, at the shapes the
     main path gives them: tier_min_d2 on frame 0's two calls and on
     crafted descriptor sets at both shipped tier tables (bit for bit,
     and equal to the old design, _stacked_windows + min_d2 per tier);
     union_find on random and adversarial graphs and frame 0's edges
     (equal; beside it uf_serial, the serial design it replaced), and
     cc_labels_hybrid on frame 0's edges and the 20k graph (one union_find
     launch a call, equal to the twin and to union_find alone; those
     launches join union_find's count in the JSON line); min_d2
     at all 12 stixel tier shapes (<= 4 ULP); with CUDA-event times,
     torch.profiler's device time, the PyTorch call that computes the
     same function (where there is one) and the least time the card could
     take (bound); then both main-path kernels' batched launches on
     frames 0-7's own calls (phase 7) against 8 single launches and the
     batched twins, bit for bit, timed;
  15. probes: the union-find probes first (check_uf_probes): uf_probe,
     uf_serial, uf_packed and uf_packed_noskip equal to the twin and scipy
     on every contract graph, ragged edge arrays and the three graphs
     below, one launch a call, a misaligned edge view raising; then on
     probe_uf's graph, probe_uf2's fallback graph and frame 0's edges the
     share of edges the window screen takes off lane 0 (the schedule
     model), each variant with kernel ms (events around isolated calls),
     device ms (torch.profiler: total over the calls and the mean of the
     events it kept, with their count), warm ms (events over back-to-back
     calls), host us a call and ns a live edge, the SM clock and power of
     the card in use sampled by nvidia-smi during the kernel and warm
     runs, union_find beside them, and the events / profiler ratios over
     every turn, with the events a profile keeps without its warm-up
     step; then the pair kernels (pair_min_d2_v48 / _v96, reading the
     caller's row layout in place): equal to the twin bit for bit on the
     JAX probes' inputs in their own layouts (and through mosaic_pairs /
     mosaic3_pairs: one launch and one CUDA kernel a call by
     torch.profiler) and on every crafted case of
     tools/kernel_cases.py::pair_cases in the stacked (L = 8), row
     (L = 128, padded) and planar layouts; a misshapen layout raises;
     each call, the twin, and cdist + amin (the library call), timed;
     mosaic2's A (gather_sum, one kernel a call, both designs) and C
     (tile_scale) equal to their twins at the probe's size and ragged
     ones; B (slice_sum) bit for bit its numpy order model for the grid
     the wrapper reports and within 1e-5 of the sum of |terms| of the
     twin on every case of kernel_cases.py::slice_cases (n 16384 / 16383
     / 1 / 0 x W 384 / 383 / 1 x R 2 / 640, clamped offsets), the same
     bits on 3 calls and on two streams (a workspace each), a misaligned
     view raising, one launch and one CUDA kernel a call; then each of
     the three, its library call (take + sum, mul, index_select + sum),
     and it again in turns, with the launch path's host split; frame 0's
     edge list through every union-find kernel and the twin (all equal),
     and its small ambiguous supernode pairs in the planar layout through
     the pair kernel and through _stacked_windows + min_d2_planar (bit
     for bit); where a parent tree is unpacked under build/parent (git
     archive), its pair kernels and slice_sum against this tree's in
     turns (parent, change, change, parent; tools/kernel_bench.py, each
     tree in a process of its own; the same pair minima in every tree,
     and each tree's slice_sum the same bits in every run and within
     1e-5 of the sum of |terms|); then the probe entry
     points (tools/probe_*.main) with the launch counts reset: every
     probe kernel must have run. Every kernel row of phases 14-15 is timed
     by kernel ms (CUDA events around isolated calls), device ms
     (torch.profiler, retried until a profile keeps every call's kernel
     events, with their count, else "not measured" with every profile's
     count), warm ms (events around back-to-back calls) and host us a
     call (the host clock, no synchronise in the loop), and so is each
     library call beside a probe kernel;
  15b. the compiled step's profiles and turns, after the probes, whose
     profiles need no graph held: torch.profiler on one parallel graph's
     replay (cluster_spatial at 8 shards on one NCCL rank): one
     cudaGraphLaunch and no kernel launch call, its hand kernels' runs
     equal to its nodes; then on the main path's graph,
     one cudaGraphLaunch and no kernel launch call a step against the
     eager step's ~2880, and a replay running as many tier_min_d2_kernel
     and union_find_kernel as the graph holds nodes of; then
     tools/step_bench.py's turns (eager, graph,
     graph, eager) at B = 1, 4 and 8 and for a cellgraph B = 1 step:
     device p50, ms a frame, host us a dispatch, idle share, kernels and
     launch calls (one cudaGraphLaunch and no kernel launch call a
     replay), capture seconds and graph pool against the eager step's
     peak, end to end through ReplayStream on each route, and an eager
     B = 8 step's ops by device time;
  16. no jax imported.

Prints each phase's seconds, the kernels' JSON record, the card's name and
power limit, and, as its last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import platform
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from lidar_processing_tpu_torch.tools.kernel_bench import (
    HOST_CALLS, DeviceMs, cuda_ms, device_ms, fmt_ms, fmt_timing, host_us,
    kernel_counts, kernels_per_call, launches_of, profiled, timing, warm_ms)
from lidar_processing_tpu_torch.tools.step_bench import top_ops

HERE = Path(__file__).resolve().parent
PARENT = HERE / "build" / "parent"  # an earlier commit, for parent_turns
N_FRAMES = 8
WARMUP_FRAMES = 1          # ReplayStream.run() warms up with one step
CLUSTER_RANGE = (300, 600)  # io/synthetic.py full-size scene targets
CSRC = "lidar_processing_tpu_torch/csrc"
# NVIDIA H100 SXM data sheet: HBM3 rate, FP32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
CDIST = "donot_use_mm_for_euclid_dist"
# each main-path kernel wrapper's CUDA kernel, as torch.profiler names it
KERNEL_OF = {"tier_min_d2": "tier_min_d2_kernel",
             "union_find": "union_find_kernel", "min_d2": "min_d2_kernel",
             "stamp": "globaltimer_stamp_kernel"}
STAMP_SLACK_NS = 20_000    # clock drift allowed beyond the calibration's
BATCHES = (4, 8)           # frames per batched step, beside B = 1
KERNELS_B1_MAX = 2995      # CUDA kernels a B = 1 step: 2852 measured + 5%
CELL_CAPACITY = 128        # the cellgraph phase's cell_capacity (shipped: 64)
NB_QUERIES = 4096          # NeighborIndex queries on frame 0
SPATIAL_SHARDS = (8, 4)    # x-band shards of the parallel phase
SPATIAL_BLOCK_POINTS = 131072  # the spatial step's block_points (32768)
UF_PROFILE = 10            # calls a union-find probe's profile records
UF_HOST_CALLS = 50         # calls its host-us measurement loops over
SMI_MS = 20                # nvidia-smi's sampling interval beside a timing
TURN_LEGEND = (f"a turn: kernel ms [median SM clock, power draw sampled "
               f"by nvidia-smi every {SMI_MS} ms] / device ms (profiler "
               f"total / {UF_PROFILE} calls) (events it kept: their mean "
               f"ms) / warm ms [clock, power] / host us a call / ns a live "
               f"edge (mean kept event)")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def host_cpu() -> str:
    """The host CPU's architecture, model and core count (host times
    follow it): /proc/cpuinfo's "model name" on x86, the implementer and
    part codes on Arm."""
    info = {}
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = line.partition(":")
        info.setdefault(key.strip(), value.strip())
    model = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("CPU implementer", "CPU part")
        if k in info) or "model not reported"
    return f"{platform.machine()} {model}, {os.cpu_count()} cores"


def bound(n_bytes: float, n_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the FP32 operations over the FP32 peak."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_FP32_PER_S * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


def rank(kernel: dict, library: dict, by: str) -> str:
    """Kernel against library by one metric of two timing() dicts."""
    k, lib = (t[by].ms if isinstance(t[by], DeviceMs) else t[by]
              for t in (kernel, library))
    if k is None or lib is None:
        return "not measured"
    return (f"the kernel {lib / k:.2f}x under the library" if k <= lib
            else f"the kernel {k / lib:.2f}x over the library")


def ulp_diff(a, b) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def smi_card() -> list:
    """nvidia-smi's -i for the card this process uses as cuda:0, by its
    UUID: nvidia-smi ignores CUDA_VISIBLE_DEVICES."""
    import torch
    uuid = str(torch.cuda.get_device_properties(0).uuid)
    return ["-i", uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"]


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
        ["nvidia-smi", *smi_card(), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; host CPU {host_cpu()}; "
        f"nvidia-smi reads cuda:0 as {smi_card()[1]}")
    return torch.device("cuda", 0), smi


def build_all():
    """The CUDA kernels (nvcc) and the host C++ module (g++), built at the
    same time; returns the seconds of each build."""
    from lidar_processing_tpu_torch.kernels import _build
    from lidar_processing_tpu_torch.native import _build as native

    def timed(build, library):
        t0 = time.perf_counter()
        info = build()
        library()
        return info, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cuda = pool.submit(timed, _build.build, _build.library)
        host = pool.submit(timed, native.build, native.library)
        (info, secs), (ninfo, nsecs) = cuda.result(), host.result()
    log(f"build: {info.path.name} from {[p.name for p in _build._sources()]}"
        f" flags {' '.join(_build.NVCC_FLAGS)} in {secs:.2f} s")
    entry, spill = "?", ""
    for line in info.log.splitlines():   # ptxas -v, kernel by kernel
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line or "smem" in line or "error" in line:
            log(f"  nvcc: {entry}: {line.strip()}; {spill}")
    march = next((line.split()[-1] for line in native.host_target(
        native._cxx()).splitlines() if line.strip().startswith("-march=")),
        "?")
    log(f"build: {ninfo.path.name} from {native.SOURCE.name} flags "
        f"{' '.join(native.CXX_FLAGS)} (-march=native is {march} here) in "
        f"{nsecs:.2f} s (g++ {ninfo.seconds:.2f} s)")
    return secs, nsecs


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
    import torch
    rng = np.random.default_rng(0)
    worst, max_abs, plain_ms, lib_ms, bound_ms = 0, 0.0, 0.0, 0.0, 0.0
    sums = {"kernel": 0.0, "device": 0.0, "warm": 0.0, "host": 0.0,
            "library device": 0.0}
    for u_cap, v_cap, slots in sx._TIERS_INTRA + sx._TIERS_SNP:
        p, wu, wv = slots, u_cap + 8, v_cap + 32
        args = min_d2_inputs(rng, p, wu, wv, device)
        u, v = torch.stack(args[:3], -1), torch.stack(args[3:], -1)
        got = min_d2_planar(*args).cpu().numpy()
        want = min_d2_planar_ref(*args).cpu().numpy()
        ulp = ulp_diff(got, want)
        if got.shape != (p,) or ulp > 4:
            raise AssertionError(f"min_d2 ({p},{wu},{wv}): {ulp} ULP")
        worst = max(worst, ulp)
        max_abs = max(max_abs, float(np.abs(got - want).max(initial=0.0)))
        t = timing(lambda: min_d2_planar(*args))
        t_p = cuda_ms(lambda: min_d2_planar_ref(*args))
        lib = lambda: torch.cdist(u, v, compute_mode=CDIST).amin(  # noqa
            (1, 2))
        t_l, d_l = cuda_ms(lib), device_ms(lib, reps=3)
        # 9 FP32 operations per (u, v) element pair: 3 sub, 3 mul, 2 add,
        # 1 min; each window float read once, P floats written
        b = bound(4 * (3 * p * (wu + wv) + p), 9 * p * wu * wv)
        plain_ms, lib_ms = plain_ms + t_p, lib_ms + t_l
        bound_ms += b["bound_ms"]
        for k, x in (*t.items(), ("library device", d_l)):
            x = x.ms if isinstance(x, DeviceMs) else x
            sums[k] = None if sums[k] is None or x is None else sums[k] + x
        log(f"min_d2 ({p:5d},{wu:3d},{wv:3d}): {ulp} ULP, {fmt_timing(t)}, "
            f"plain {t_p:.4f} ms, cdist+amin {t_l:.4f} ms (device "
            f"{fmt_ms(d_l)}), bound {b['bound_ms']:.5f} ms "
            f"({b['bound_by']})")
    log(f"min_d2: 12 tier shapes, max {worst} ULP; per-frame sums: "
        + ", ".join(f"{k} {fmt_ms(x) if k != 'host' else f'{x:.2f} us'}"
                    for k, x in sums.items())
        + f", plain {plain_ms:.4f} ms, cdist+amin {lib_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms")
    ms = sums["kernel"]
    return {"name": "min_d2", "source": f"{CSRC}/min_d2.cu",
            "replaces": "lidar_processing_tpu/kernels/min_d2.py:48",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations",
            "library_ms": lib_ms}


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


def check_union_find(device, frame_edges):
    """union_find against the twin on random graphs, on the contract's
    adversarial graphs and on frame 0's edge list (all equal); timed on
    frame 0's edges and on a 20k-edge graph beside uf_serial, the serial
    design it replaced, the twin and the bound."""
    import torch
    from lidar_processing_tpu_torch.kernels.probe_uf import uf_serial
    from lidar_processing_tpu_torch.kernels.union_find import (cc_labels,
                                                               cc_labels_ref)
    from lidar_processing_tpu_torch.tools.kernel_cases import (uf_graphs,
                                                               uf_oracle)
    rng = np.random.default_rng(1)
    ec = 32768
    max_abs = 0

    def check(name, g, s_cap, oracle=None):
        nonlocal max_abs
        got = cc_labels(*g, s_cap).cpu().numpy()
        want = cc_labels_ref(*g, s_cap).cpu().numpy()
        bad = got.shape != (s_cap,) or not np.array_equal(got, want)
        if bad or (oracle is not None and not np.array_equal(got, oracle)):
            raise AssertionError(f"union_find {name}: "
                                 f"{np.sum(got != want)} differ")
        max_abs = max(max_abs, int(np.abs(got - want).max(initial=0)))
        timed = ""
        if oracle is not None:   # a contract graph: its device time too
            timed = ", device " + fmt_ms(device_ms(lambda: cc_labels(*g,
                                                                  s_cap)))
        log(f"union_find {name}: equal ({len(np.unique(got))} components"
            f"{timed})")

    for s_cap, n_edges in ((128, 0), (128, 300), (2048, 4000),
                           (2048, 32768), (10240, 0), (10240, 20000),
                           (10240, 32768)):
        check(f"random s_cap={s_cap} n_edges={n_edges}",
              random_graph(rng, s_cap, ec, n_edges, device), s_cap)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    for name, eu, ev, ne in uf_graphs():
        check(name, (to(eu), to(ev), torch.tensor(ne, dtype=torch.int32,
                                                  device=device)),
              10240, uf_oracle(eu, ev, ne, 10240))
    check("frame 0 edges", frame_edges, 10240)

    # timed at the main path's shape: s_cap = max_supernodes, 32768 edge
    # slots; frame 0's edges and ~20k live edges (the KITTI maximum the
    # caps were sized for)
    g20k = random_graph(rng, 10240, ec, 20000, device)
    rows = {}
    for gname, g in (("frame 0", frame_edges), ("20k", g20k)):
        n_e = int(g[2])
        t = {name: (cuda_ms(lambda: fn(*g, 10240)),
                    device_ms(lambda: fn(*g, 10240)))
             for name, fn in (("kernel", cc_labels), ("uf_serial", uf_serial),
                              ("plain", cc_labels_ref))}
        b = uf_bound(n_e, 8, 10240)
        rows[gname] = (t, b)
        kernel = lambda: cc_labels(*g, 10240)  # noqa: E731
        log(f"union_find on {gname} ({n_e} edges, 10240 nodes): "
            + ", ".join(f"{k} {ms:.4f} ms (device {fmt_ms(d)})"
                        for k, (ms, d) in t.items())
            + f"; kernel warm {warm_ms(kernel):.4f} ms, host "
            f"{host_us(kernel):.2f} us; bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']})")
    t, b = rows["20k"]
    return ({"name": "union_find", "source": f"{CSRC}/union_find.cu",
             "replaces": "lidar_processing_tpu/kernels/union_find.py:31",
             "max_abs_err": max_abs, "ms": t["kernel"][0],
             "plain_ms": t["plain"][0], **b, "library_ms": None},
            check_hybrid({"frame 0": frame_edges, "20k": g20k}))


def check_hybrid(graphs) -> int:
    """cc_labels_hybrid (two hook rounds, the live label pairs deduped,
    then the union_find kernel on them) on each graph, counts set to 0
    first: one union_find launch a call, labels equal to cc_labels_ref
    and to cc_labels alone, bit for bit; then its time beside
    cc_labels'. Returns the launches of the counted calls."""
    from lidar_processing_tpu_torch.kernels.union_find import (
        cc_labels, cc_labels_hybrid, cc_labels_ref)
    cc_labels.launches = 0
    got = {name: cc_labels_hybrid(*g, 10240) for name, g in graphs.items()}
    launches = cc_labels.launches
    if launches != len(graphs):
        raise AssertionError(f"cc_labels_hybrid: {launches} union_find "
                             f"launches for {len(graphs)} calls")
    for name, g in graphs.items():
        for twin, fn in (("cc_labels_ref", cc_labels_ref),
                         ("cc_labels", cc_labels)):
            if not same_bits(got[name], fn(*g, 10240)):
                raise AssertionError(f"cc_labels_hybrid on {name} differs "
                                     f"from {twin}")
        t = {k: (cuda_ms(lambda: fn(*g, 10240)),
                 device_ms(lambda: fn(*g, 10240)))
             for k, fn in (("hybrid", cc_labels_hybrid),
                           ("union_find alone", cc_labels))}
        log(f"cc_labels_hybrid on {name} ({int(g[2])} edges): == "
            f"cc_labels_ref == cc_labels bit for bit, one union_find launch; "
            + ", ".join(f"{k} {ms:.4f} ms (device {fmt_ms(d)})"
                        for k, (ms, d) in t.items()))
    return launches


def tier_work(args, tiers):
    """(bytes, FP32 operations) one tier pass needs on these inputs: 12 B
    per point of each active slot's two runs (counts clamped to the caps),
    the active descriptors (8 B a slot), the starts and counts, 4 B out
    per slot, and 9 operations per real point pair."""
    _, usuc, vsvc, starts, n_in = (a.cpu().numpy().astype(np.int64)
                                   for a in args[:5])
    n_bytes, ops = 8 * len(tiers) + 4 * sum(s for *_, s in tiers), 0
    for t, (u_cap, v_cap, slots) in enumerate(tiers):
        lo = min(max(starts[t], 0), len(usuc) - slots)
        act = slice(lo, lo + min(n_in[t], slots))
        un = np.minimum(usuc[act] & 511, u_cap)
        vn = np.minimum(vsvc[act] & 511, v_cap)
        n_bytes += 12 * int(un.sum() + vn.sum()) + 8 * len(un)
        ops += 9 * int((un * vn).sum())
    return n_bytes, ops


def check_tier_min_d2(device, frame_calls):
    """tier_min_d2 against its twin, bit for bit, on frame 0's two calls
    and on crafted descriptor sets at both shipped tier tables; and
    against the old design (each tier's windows through min_d2). Timed on
    frame 0's calls (the main path's inputs)."""
    import torch
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG as cfg
    from lidar_processing_tpu_torch.kernels.min_d2 import min_d2_planar
    from lidar_processing_tpu_torch.kernels.tier_min_d2 import (
        tier_min_d2, tier_min_d2_ref, tier_slices, tier_windows)
    from lidar_processing_tpu_torch.ops import stixel as sx
    from lidar_processing_tpu_torch.tools.kernel_cases import tier_cases

    def old_design(*args):
        return torch.cat([min_d2_planar(*pu, *pv) for pu, pv in tier_windows(
            args[0], tier_slices(*args[1:]), args[-1])])

    no = cfg.pipeline.max_obstacle_points
    sets = [(f"frame 0 {name}", args) for name, args in
            zip(("intra", "snp"), frame_calls)]
    for table, tiers in (("intra", sx._TIERS_INTRA), ("snp", sx._TIERS_SNP)):
        for name, *case in tier_cases(tiers, n=no, seed=len(table)):
            sets.append((f"{table} {name}", (*(torch.from_numpy(a).to(device)
                                               for a in case), tiers)))
    for name, args in sets:
        got, want = tier_min_d2(*args), tier_min_d2_ref(*args)
        if not same_bits(got, want):
            raise AssertionError(f"tier_min_d2 {name}: "
                                 f"{int((got != want).sum())} slots differ "
                                 f"from the twin")
        if not same_bits(old_design(*args), got):
            raise AssertionError(f"tier_min_d2 {name}: differs from "
                                 f"windows + min_d2")
        log(f"tier_min_d2 {name}: {got.numel()} slots, bit-identical to the "
            f"twin and to windows + min_d2")
    total = {"ms": 0.0, "plain_ms": 0.0}
    work = np.zeros(2)
    for name, args in sets[:2]:
        t = {k: (cuda_ms(lambda: fn(*args)), device_ms(lambda: fn(*args)))
             for k, fn in (("kernel", tier_min_d2),
                           ("windows + min_d2", old_design),
                           ("plain", tier_min_d2_ref))}
        w = tier_work(args, args[-1])
        b = bound(*w)
        work += w
        total["ms"] += t["kernel"][0]
        total["plain_ms"] += t["plain"][0]
        kernel = lambda: tier_min_d2(*args)  # noqa: E731
        log(f"tier_min_d2 {name} ({int(args[4].sum())} pairs in tiers): "
            + ", ".join(f"{k} {ms:.4f} ms (device {fmt_ms(d)})"
                        for k, (ms, d) in t.items())
            + f"; kernel warm {warm_ms(kernel):.4f} ms, host "
            f"{host_us(kernel):.2f} us; bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']})")
    total.update(bound(*work))
    log(f"tier_min_d2 per frame (2 calls): kernel {total['ms']:.4f} ms, "
        f"plain {total['plain_ms']:.4f} ms, bound {total['bound_ms']:.6f} ms "
        f"({total['bound_by']}; {int(work[0])} B, {int(work[1])} FP32 "
        f"operations)")
    return {"name": "tier_min_d2", "source": f"{CSRC}/tier_min_d2.cu",
            "replaces": "lidar_processing_tpu/kernels/min_d2.py:48",
            "max_abs_err": 0.0, **total, "library_ms": None}


def uf_bound(n_edges: int, edge_bytes: int, s_cap: int) -> dict:
    """Union-find reads each live edge once, n_edges, and writes s_cap
    labels; no PyTorch call computes connected components."""
    return bound(edge_bytes * n_edges + 4 + 4 * s_cap)


def pair_bound(us, uc, vs, vc, v_cap: int, n: int) -> dict:
    """What the pair function needs on these runs: each point of any run
    read once (12 B), 4 index words in and 1 float out per pair, and 9
    FP32 operations per (u, v) point pair."""
    uc, vc = np.minimum(uc, 8), np.minimum(vc, v_cap)
    mark = np.zeros(n + 1, np.int64)
    for st, cn in ((us, uc), (vs, vc)):
        np.add.at(mark, np.clip(st, 0, n), 1)
        np.add.at(mark, np.clip(st + cn, 0, n), -1)
    touched = int((np.cumsum(mark)[:n] > 0).sum())
    ops = 9 * float((uc.astype(np.int64) * vc).sum())
    return bound(12 * touched + 20 * len(us), ops)


class SmiSampler:
    """nvidia-smi sampling the SM clock, power draw and power limit of
    the card in use (smi_card) every SMI_MS ms in a process of its own
    while the block runs; `samples` holds (MHz, W, W) rows taken after the
    sampler was up (empty when nvidia-smi gave none). The process is
    stopped on exit."""

    def __enter__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", *smi_card(),
             "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader,nounits", "-lms", str(SMI_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.proc.stdout.readline()     # up and sampling from here on
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        for line in out.splitlines():
            try:
                self.samples.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                pass
        return False

    def clock(self) -> str:
        """Median SM MHz / power W of the samples."""
        if not self.samples:
            return "not measured"
        mhz = sorted(r[0] for r in self.samples)
        watts = sorted(r[1] for r in self.samples)
        return f"{mhz[len(mhz) // 2]:.0f} MHz {watts[len(watts) // 2]:.0f} W"


def kernel_device_ms(fn, reps: int = 10):
    """fn() runs one CUDA kernel: (ms a call as torch.profiler's total over
    `reps` calls, the mean of the kernel events it kept, and how many it
    kept). A profile that drops events makes the first understate and
    leaves the second; (None, None, 0) if it saw none."""
    import torch
    total_us, kept = 0.0, 0
    for e in profiled(fn, reps):
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total_us += e.self_device_time_total
            kept += e.count
    if kept == 0:
        return None, None, 0
    return total_us / 1e3 / reps, total_us / 1e3 / kept, kept


def uf_turn(fn) -> dict:
    """One turn of a union-find kernel: kernel ms (CUDA events around each
    of >= 10 isolated calls, median, ~0.1 s of them) with the SM clock
    sampled meanwhile; device ms (torch.profiler over UF_PROFILE calls:
    total / calls and the mean of the kept events, with their count); warm
    ms (events over as many back-to-back calls) with the clock sampled;
    host us a call (UF_HOST_CALLS calls, no synchronise in the loop)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(10, min(200, int(0.1 / max(time.perf_counter() - t0, 1e-4))))
    with SmiSampler() as iso:
        k_ms = cuda_ms(fn, reps)
    d_ms, d_event_ms, kept = kernel_device_ms(fn, UF_PROFILE)
    with SmiSampler() as warm:
        w_ms = warm_ms(fn, reps)
    return {"kernel": k_ms, "device": d_ms, "event": d_event_ms,
            "kept": kept, "warm": w_ms, "host": host_us(fn, UF_HOST_CALLS),
            "clock_iso": iso.clock(), "clock_warm": warm.clock()}


def fmt_turn(t: dict, n_edges: int) -> str:
    """One uf_turn, in TURN_LEGEND's order."""
    ns = ("-" if t["event"] is None
          else f"{t['event'] * 1e6 / max(n_edges, 1):.1f}")
    ev = "-" if t["event"] is None else f"{t['event']:.4f}"
    return (f"{t['kernel']:.4f} [{t['clock_iso']}] / {fmt_ms(t['device'])} "
            f"({t['kept']}: {ev}) / {t['warm']:.4f} [{t['clock_warm']}] / "
            f"{t['host']:.1f} us / {ns} ns")


def check_uf_probes(device, frame_edges, smi: str) -> list:
    """The union-find probe kernels of csrc/probe_uf.cu (uf_probe,
    uf_serial, uf_packed, uf_packed_noskip): each equal to the twin and to
    scipy on every contract graph and on the three graphs timed below, and
    on ragged edge arrays (ec no multiple of 4); a misaligned edge view
    raises. Then on probe_uf's graph, probe_uf2's fallback graph and frame
    0's edges: the share of edges the schedule model screens off lane 0,
    a uf_turn of each variant and of union_find; the events-against-
    profiler ratios over every turn, and the kernel events a profile of
    UF_PROFILE calls keeps without its warm-up step. Returns the 4
    kernels' records (on the JAX probe's own graph)."""
    import torch
    from lidar_processing_tpu_torch.kernels import probe_uf as puf
    from lidar_processing_tpu_torch.kernels.union_find import (cc_labels,
                                                               cc_labels_ref)
    from lidar_processing_tpu_torch.tools import probe_uf, probe_uf2
    from lidar_processing_tpu_torch.tools.kernel_cases import (uf_graphs,
                                                               uf_oracle)
    s = probe_uf.S
    i32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=torch.int32, device=device)
    graphs = {"probe_uf": tuple(map(i32, probe_uf.make_inputs())),
              "probe_uf2": tuple(map(i32, probe_uf2.make_inputs())),
              "frame 0": tuple(frame_edges)}

    def calls(name, g, s_cap=s):
        """(kernel call, its edges unpacked as the kernel reads them)."""
        fn = getattr(puf, name)
        if name.startswith("uf_packed"):
            euv = puf.pack_edges(g[0], g[1])
            return (lambda: fn(euv, g[2], s_cap)), puf.unpack_edges(euv)
        return (lambda: fn(*g, s_cap)), g[:2]

    contract = [(n, *map(i32, (eu, ev, ne)), uf_oracle)
                for n, eu, ev, ne in uf_graphs()]
    for gname, *g, oracle in contract + [(k, *g, None)
                                         for k, g in graphs.items()]:
        for name in puf.VARIANTS:
            call, (a, b) = calls(name, g)
            before = getattr(puf, name).launches
            got = call()
            if getattr(puf, name).launches != before + 1:
                raise AssertionError(f"{name} on {gname}: not one launch")
            want = cc_labels_ref(a, b, g[2], s)
            if not torch.equal(got, want) or (oracle is not None and not
                    np.array_equal(got.cpu().numpy(), oracle(
                        a.cpu().numpy(), b.cpu().numpy(), int(g[2]), s))):
                raise AssertionError(f"{name} on {gname}: "
                                     f"{int((got != want).sum())} differ")
    rng = np.random.default_rng(7)
    for ec in (1001, 4099):
        eu = rng.integers(0, 300, ec)
        g = (i32(eu), i32(np.minimum(299, eu + rng.integers(1, 4, ec))),
             i32(ec + 3))
        for name in puf.VARIANTS:
            call, (a, b) = calls(name, g, 300)
            if not torch.equal(call(), cc_labels_ref(a, b, g[2], 300)):
                raise AssertionError(f"{name}: ragged ec={ec} differs")
    e = i32(np.arange(1025) % 64)
    try:
        puf.uf_serial(e[1:], e[:1024], i32(1000), 64)
        raise AssertionError("uf_serial took an edge view off 16 bytes")
    except ValueError:
        pass
    log(f"union-find probes: the 4 kernels == the twin on the "
        f"{len(contract)} contract graphs (== scipy), ragged ec 1001 and "
        f"4099, and {', '.join(graphs)}; one launch a call; a misaligned "
        f"edge view raises")

    line = {"uf_probe": "tools/probe_uf.py:26",
            "uf_serial": "tools/probe_uf2.py:50",
            "uf_packed": "tools/probe_uf2.py:77",
            "uf_packed_noskip": "tools/probe_uf2.py:105"}
    records, every = [], []
    for gname, g in graphs.items():
        n_e = int(g[2])
        eu_np, ev_np = g[0].cpu().numpy(), g[1].cpu().numpy()
        _, screened = puf.schedule_model(eu_np, ev_np, n_e, s, True, True)
        _, outcome = puf.serial_model(eu_np, ev_np, n_e, s, True, True)
        log(f"union-find probes on {gname} ({n_e} live edges, {s} nodes; "
            f"{smi}; {TURN_LEGEND}): the window screen takes "
            f"{len(screened)} ({len(screened) / max(n_e, 1):.1%}) of the "
            f"edges off lane 0 (schedule_model); the serial pass skips "
            f"{outcome.count('skip')} "
            f"({outcome.count('skip') / max(n_e, 1):.1%})")
        for variant in puf.VARIANTS:
            call, (a, b) = calls(variant, g)
            turn = uf_turn(call)
            every.append(turn)
            log(f"  {variant}: {fmt_turn(turn, n_e)}")
            own = "probe_uf" if variant == "uf_probe" else "probe_uf2"
            if gname == own:
                want = cc_labels_ref(a, b, g[2], s)
                err = int((call() - want).abs().max())
                ebytes = 4 if variant.startswith("uf_packed") else 8
                records.append({
                    "name": variant, "source": f"{CSRC}/probe_uf.cu",
                    "replaces": line[variant], "max_abs_err": err,
                    "ms": turn["kernel"],
                    "plain_ms": cuda_ms(lambda: cc_labels_ref(a, b, g[2], s)),
                    **uf_bound(n_e, ebytes, s), "library_ms": None})
        log(f"  union_find: "
            f"{fmt_turn(uf_turn(lambda: cc_labels(*g, s)), n_e)}")

    def spread(k):
        r = [t[k] / t["event"] for t in every if t["event"]]
        return f"{min(r):.3f}-{max(r):.3f}" if r else "not measured"
    lost = sum(t["kept"] < UF_PROFILE for t in every)
    call, _ = calls("uf_serial", graphs["probe_uf2"])
    cold = [sum(e.count for e in profiled(call, UF_PROFILE, warmup=False)
                if e.device_type == torch.autograd.DeviceType.CUDA)
            for _ in range(3)]
    log(f"events against the profiler over {len(every)} turns: kernel ms / "
        f"device ms per kept event {spread('kernel')}, warm ms / it "
        f"{spread('warm')}, device ms (total / calls) / it "
        f"{spread('device')}; profiles that kept fewer than {UF_PROFILE} of "
        f"{UF_PROFILE} events: {lost}; without the warm-up step, 3 profiles "
        f"of {UF_PROFILE} uf_serial calls kept {cold} kernel events")
    return records


def check_pairs(device) -> list:
    """pair_min_d2_v48 / _v96 against the twin bit for bit: on the JAX
    probes' inputs in their own layouts (and through mosaic_pairs /
    mosaic3_pairs, one launch each), and on every crafted case of
    kernel_cases.pair_cases in the three layouts (stacked L = 8, rows
    L = 128 with padding, planar); a misshapen or non-contiguous layout
    raises; mosaic_pairs / mosaic3_pairs run one CUDA kernel a call
    (torch.profiler). Then on the probes' inputs: the kernel on a ready
    layout, the user call and the library call (cdist + amin over the
    filled windows) by timing() (kernel, device, warm ms, host us), the
    twin and the bound, ranked by device and warm ms. Returns the two
    records."""
    import torch
    from lidar_processing_tpu_torch.kernels import probe_pairs as pp
    from lidar_processing_tpu_torch.tools import probe_mosaic, probe_mosaic3
    from lidar_processing_tpu_torch.tools.kernel_cases import (pair_cases,
                                                               pair_layouts)
    to = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa
    records = []
    for name, fn, user, v_cap, (_, rows_np, *runs), lanes, replaces in (
            ("pair_min_d2_v48", pp.pair_min_d2_v48,
             lambda r, u: pp.mosaic_pairs(r, *u), 48,
             probe_mosaic.make_inputs(), 8, "tools/probe_mosaic.py:26"),
            ("pair_min_d2_v96", pp.pair_min_d2_v96,
             lambda r, u: pp.mosaic3_pairs(*u, r), 96,
             probe_mosaic3.make_inputs(), 128,
             "tools/probe_mosaic3.py:57")):
        rows, truns = to(rows_np), tuple(map(to, runs))
        planes = pp.row_planes(rows, lanes)
        want = pp.pair_min_d2_ref(*planes, *truns, v_cap)
        calls = {
            "kernel": lambda: fn(rows, lanes, *truns),
            "user call": lambda: user(rows, truns)}
        before = fn.launches
        for call, c in calls.items():
            if not torch.equal(c(), want):
                raise AssertionError(f"{name} {call}: differs from the twin")
        if fn.launches != before + len(calls):
            raise AssertionError(f"{name}: not one launch a call")
        n_cases = 0
        for case, xyz, *cruns in pair_cases(v_cap):
            cruns = tuple(map(to, cruns))
            for layout, (points, ln, pl_) in pair_layouts(xyz).items():
                w = pp.pair_min_d2_ref(*to(pl_), *cruns, v_cap)
                if not torch.equal(fn(to(points), ln, *cruns), w):
                    raise AssertionError(f"{name} on {case}, {layout}: "
                                         f"differs")
                n_cases += 1
        for bad in (rows[:, :-1], rows.reshape(-1),
                    torch.cat([rows, rows], 1)[:, ::2]):
            try:
                fn(bad, lanes, *truns)
                raise AssertionError(f"{name} took a layout "
                                     f"{tuple(bad.shape)}")
            except ValueError:
                pass
        seen = kernels_per_call(calls["user call"])
        if list(seen.values()) != [1.0]:
            raise AssertionError(f"{name}: the user call ran {seen}")
        log(f"{name}: {len(want)} pairs == the twin bit for bit (and the "
            f"user call: one launch and one CUDA kernel a call, "
            f"{next(iter(seen))}); {n_cases} crafted cases x "
            f"layouts == the twin; a misshapen layout raises")
        # the library yardstick: cdist + amin over the filled windows
        u, v = (torch.stack([pp.gather_windows(a, st, cn, cap, fill)
                             for a in planes], -1)
                for st, cn, cap, fill in ((*truns[:2], pp.U_CAP, 1.0e9),
                                          (*truns[2:], v_cap, -1.0e9)))
        t = {call: timing(c) for call, c in calls.items()}
        t_lib = timing(lambda: torch.cdist(u, v, compute_mode=CDIST).amin(
            (1, 2)), calls=50)
        plain = cuda_ms(lambda: pp.pair_min_d2_ref(*planes, *truns, v_cap))
        b = pair_bound(*runs, v_cap, planes[0].shape[0])
        for call, tc in t.items():
            log(f"  {name} {call}: {fmt_timing(tc)}")
        log(f"  {name} library cdist+amin: {fmt_timing(t_lib)}; plain "
            f"{plain:.4f} ms; bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']}); by device ms "
            f"{rank(t['kernel'], t_lib, 'device')}, by warm ms "
            f"{rank(t['kernel'], t_lib, 'warm')}")
        records.append({"name": name, "source": f"{CSRC}/probe_pairs.cu",
                        "replaces": replaces, "max_abs_err": 0.0,
                        "ms": t["kernel"]["kernel"], "plain_ms": plain, **b,
                        "library_ms": t_lib["kernel"]})
    return records


def launch_split(idx, val, x) -> str:
    """Host microseconds of each step of _build.launch's path, over
    HOST_CALLS calls each."""
    import torch
    from lidar_processing_tpu_torch.kernels import _build
    dev = x.device
    out = x.new_empty((x.shape[0] // 128, 128))
    ptr, optr, n = x.data_ptr(), out.data_ptr(), x.shape[0]
    c_fn = _build._BOUND["tile_scale_launch"]
    stream = torch._C._cuda_getCurrentRawStream

    def guard():
        with torch.cuda.device(dev):
            pass
    steps = {
        "checks (tile_scale)": lambda: (
            x.shape[0] % 128, x.is_cuda,
            _build.checked("tile_scale", ("x", x, torch.float32, 1)),
            x.data_ptr() % 16),
        "checks (gather_sum)": lambda: (
            idx.is_cuda, _build.checked(
                "gather_sum", ("idx", idx, torch.int32, 1),
                ("val", val, torch.int32, 1)), val.shape[0],
            idx.data_ptr() % 16),
        "allocation (new_empty)": lambda: x.new_empty((n // 128, 128)),
        "current device": torch._C._cuda_getDevice,
        "stream read": lambda: stream(0),
        "ctypes call, GIL kept (a launch)": lambda: c_fn(ptr, optr, n,
                                                         stream(0)),
        "device guard (entered only off the current device)": guard,
    }
    return ", ".join(f"{k} {host_us(f):.2f}" for k, f in steps.items())


def check_slice_sum(device) -> None:
    """slice_sum against its order model bit for bit (for the grid the
    wrapper reports for each n) and within 1e-5 of the sum of |terms| of the twin on
    every case of tools/kernel_cases.py::slice_cases; the same bits on 3
    calls and on two streams, each with its own workspace; a misaligned
    planes view raising; one launch and one CUDA kernel a call."""
    import torch
    from lidar_processing_tpu_torch.kernels import probe_mosaic2 as m2
    from lidar_processing_tpu_torch.tools import probe_mosaic2
    from lidar_processing_tpu_torch.tools.kernel_cases import slice_cases
    to = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa
    grids, worst = set(), 0.0
    for case, off_np, planes_np in slice_cases():
        off, planes = to(off_np), to(planes_np)
        grid = m2.slice_sum_grid(device, off_np.shape[0])
        grids.add(grid)
        before = m2.slice_sum.launches
        got = [m2.slice_sum(off, planes) for _ in range(3)]
        if m2.slice_sum.launches != before + 3:
            raise AssertionError(f"slice_sum {case}: not one launch a call")
        bits = {g.cpu().numpy().tobytes() for g in got}
        model = probe_mosaic2.slice_sum_order_model(off_np, planes_np, grid)
        if bits != {model.tobytes()}:
            raise AssertionError(f"slice_sum {case}: {got[0]} (bits {bits}) "
                                 f"!= the order model's {model}")
        terms = probe_mosaic2.slice_terms(
            np.clip(off_np, 0, planes_np.shape[0] - 2), planes_np)
        tol = 1e-5 * np.abs(terms).sum()
        err = abs(float(got[0]) - float(m2.slice_sum_ref(off, planes)))
        if err > tol or (off_np.size == 0 and float(got[0]) != 0.0):
            raise AssertionError(f"slice_sum {case}: {float(got[0])} vs the "
                                 f"twin, err {err} > {tol}")
        worst = max(worst, err / tol if tol else 0.0)
    off, planes = (to(a) for a in probe_mosaic2.dyn_slice_inputs(16384))
    want = m2.slice_sum(off, planes)
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(st):
            outs.append(m2.slice_sum(off, planes))
    torch.cuda.synchronize(device)
    spaces = {m2._SLICE_WORKSPACES[(device.index, st.cuda_stream)].data_ptr()
              for st in streams}
    if len(spaces) != 2 or not all(torch.equal(o, want) for o in outs):
        raise AssertionError("slice_sum on two streams: shared workspace or "
                             "other bits")
    try:
        m2.slice_sum(off, torch.zeros(640 * 384 + 1, device=device)[1:]
                     .view(640, 384))
        raise AssertionError("slice_sum took a misaligned planes view")
    except ValueError:
        pass
    seen = kernels_per_call(lambda: m2.slice_sum(off, planes))
    if list(seen.values()) != [1.0]:
        raise AssertionError(f"slice_sum: not one kernel a call: {seen}")
    log(f"slice_sum: {len(slice_cases())} cases (n 16384/16383/1/0 x W "
        f"384/383/1 x R 2/640, clamped offsets) == the order model bit for "
        f"bit at grids {sorted(grids)}, the same bits on 3 calls, within "
        f"1e-5 of the "
        f"sum of |terms| of the twin (at most {worst:.3g} of it); two "
        f"streams, two workspaces, the same bits; a misaligned view raises; "
        f"one launch and one CUDA kernel a call ({next(iter(seen))})")


def check_mosaic2(device) -> list:
    """tools/probe_mosaic2.py's A, B, C at the probe's size (16384): A and
    C against their twins bit for bit, at 16384 and at ragged sizes, B by
    check_slice_sum; then new, the library call, new in turns, each by
    CUDA events a call (kernel ms), torch.profiler (device ms, kernels a
    call), the host clock (host us a call) and events over back-to-back
    calls (warm ms); the launch path's split. Returns the records."""
    import torch
    from lidar_processing_tpu_torch.kernels import probe_mosaic2 as m2
    from lidar_processing_tpu_torch.tools import probe_mosaic2
    to = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa
    n = 16384
    idx, val = map(to, probe_mosaic2.scalar_loads_inputs(n))
    x = to(probe_mosaic2.accum_store_inputs(n))
    # bit for bit, the probe's size and ragged ones
    for k in (n, n - 1, n - 3, 5, 0):
        i_k = idx[:k].clone()
        want = m2.gather_sum_ref(i_k, val)
        for name, got in (("gather_sum", m2.gather_sum(i_k, val)),
                          ("atomic", m2.gather_sum(i_k, val, "atomic"))):
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at n={k}: {got} != {want}")
    for k in (n, n + 128, 128):
        x_k = torch.randn(k, device=device)
        if not torch.equal(m2.tile_scale(x_k), m2.tile_scale_ref(x_k)):
            raise AssertionError(f"tile_scale at n={k} differs")
    log(f"mosaic2: gather_sum (both designs) and tile_scale == their twins "
        f"at n = {n} and ragged sizes")
    seen = kernels_per_call(lambda: m2.gather_sum(idx, val))
    if list(seen.values()) != [1.0]:
        raise AssertionError(f"gather_sum: not one kernel a call: {seen}")
    log(f"gather_sum: one kernel a call ({next(iter(seen))})")
    check_slice_sum(device)

    off_np, planes_np = probe_mosaic2.dyn_slice_inputs(n)
    off, planes = to(off_np), to(planes_np)
    # the library yardsticks' indices, made before timing
    idx_l = idx.long()
    rows = (torch.clamp(off, 0, planes.shape[0] - 2).long()[:, None]
            + torch.arange(2, device=device)).reshape(-1)
    calls = {
        "gather_sum": (lambda: m2.gather_sum(idx, val),
                       lambda: torch.take(val, idx_l).sum()),
        "tile_scale": (lambda: m2.tile_scale(x),
                       lambda: torch.mul(x, 2.0)),
        "slice_sum": (lambda: m2.slice_sum(off, planes),
                      lambda: planes.index_select(0, rows).sum())}
    timed = {}
    for name, (new, lib) in calls.items():
        t = {}
        for who, fn in (("new", new), ("library", lib), ("new", new)):
            t.setdefault(who, []).append(
                (cuda_ms(fn), device_ms(fn), host_us(fn), warm_ms(fn)))
        timed[name] = {who: tuple(
            None if None in v else statistics.mean(v) for v in (
                [x.ms if isinstance(x, DeviceMs) else x for x in col]
                for col in zip(*rows_)))
            for who, rows_ in t.items()}
        kpc = {who: sum(kernels_per_call(fn).values()) for who, fn in
               (("new", new), ("library", lib))}
        log(f"{name} in turns (new, library, new; kernel ms, device ms, "
            f"host us, warm ms a call): " + "; ".join(
                f"{who} " + " / ".join(
                    f"{a:.4f}, {fmt_ms(b)}, {c:.2f}, {d:.4f}"
                    for a, b, c, d in rows_)
                for who, rows_ in t.items()) + f"; kernels a call {kpc}")
    atomic = lambda: m2.gather_sum(idx, val, "atomic")  # noqa: E731
    log(f"gather_sum designs: cluster kernel "
        f"{timed['gather_sum']['new'][0]:.4f} ms, device "
        f"{fmt_ms(timed['gather_sum']['new'][1])}; atomic kernel "
        f"{cuda_ms(atomic):.4f} ms, device {fmt_ms(device_ms(atomic))}, "
        f"host {host_us(atomic):.2f} us")
    log(f"launch path, host us a call: {launch_split(idx, val, x)}")

    got = float(m2.slice_sum(off, planes))
    slice_err = abs(got - float(m2.slice_sum_ref(off, planes)))
    records = []
    for name, src_line, ref, b, err in (
            ("gather_sum", "tools/probe_mosaic2.py:38",
             lambda: m2.gather_sum_ref(idx, val),
             bound(4 * (idx.numel() + val.numel()) + 4), 0),
            ("slice_sum", "tools/probe_mosaic2.py:60",
             lambda: m2.slice_sum_ref(off, planes),
             bound(4 * (off.numel() + planes.numel()) + 4,
                   2 * planes.shape[1] * n), slice_err),
            ("tile_scale", "tools/probe_mosaic2.py:83",
             lambda: m2.tile_scale_ref(x), bound(8 * n), 0)):
        plain = cuda_ms(ref)
        ms, d_ms, h_us, w_ms = timed[name]["new"]
        lib = timed[name]["library"]
        records.append({
            "name": name, "source": f"{CSRC}/probe_mosaic2.cu",
            "replaces": src_line, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, **b, "library_ms": lib[0]})
        log(f"{name}: kernel {ms:.4f} ms (device {fmt_ms(d_ms)}, host "
            f"{h_us:.2f} us, warm {w_ms:.4f} ms), plain {plain:.4f} ms, "
            f"library {lib[0]:.4f} ms (device {fmt_ms(lib[1])}, host "
            f"{lib[2]:.2f} us, warm {lib[3]:.4f} ms), bound "
            f"{b['bound_ms']:.6f} ms ({b['bound_by']}); max abs err {err}")
    return records


def knife_config(backend: str = "stixel"):
    """tools/knife_cases.py's caps; the cellgraph at cell_capacity
    CELL_CAPACITY with its ambiguous-pair slots cut to the cloud (its
    d² rounding does not follow the caps)."""
    import dataclasses
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    from lidar_processing_tpu_torch.tools import knife_cases as kc
    pcfg = kc.PIPELINE
    if backend == "cellgraph":
        pcfg = dataclasses.replace(pcfg, clustering_backend="cellgraph",
                                   cell_capacity=CELL_CAPACITY,
                                   max_ambiguous_pairs=4096)
    return DEFAULT_CONFIG.replace(pipeline=pcfg, spatial=kc.SPATIAL)


def check_knife(device) -> None:
    """The crafted knife-edge pairs (tools/knife_cases.py: the KNIFE rows
    and one pair per d² screen) through the port on the card and on the
    CPU: stixel ``cluster``, the cellgraph ``cluster`` and
    ``cluster_spatial`` at 2 bands (on the card its graph, released
    after). Labels CUDA == CPU bit for bit, and
    every verdict the stored one (the JAX package's on the CPU, but for
    the bands' k = 1 cell rep screen, whose rounding XLA picks by shape)."""
    import torch
    from lidar_processing_tpu_torch.io.synthetic import pad_frame
    from lidar_processing_tpu_torch.ops import clustering as tcl
    from lidar_processing_tpu_torch.ops import stixel as sx
    from lidar_processing_tpu_torch.parallel.sharded import make_mesh
    from lidar_processing_tpu_torch.parallel.spatial import cluster_spatial
    from lidar_processing_tpu_torch.tools import knife_cases as kc
    cfg, cg = knife_config(), knife_config("cellgraph")
    paths = {
        "stixel": lambda x, m: sx.cluster(x, m, cfg.clustering,
                                          cfg.pipeline),
        "cellgraph": lambda x, m: tcl.cluster(x, m, cg.clustering,
                                              cg.pipeline),
        "bands": lambda x, m: cluster_spatial(
            make_mesh(2, "space", device=x.device), x, m, cfg.clustering,
            cfg.pipeline, cfg.spatial)}
    xyz, cases = kc.screen_cloud()
    clouds = {"screens": pad_frame(xyz, cfg.pipeline.max_points),
              "KNIFE": pad_frame(kc.knife_rows(), cfg.pipeline.max_points)}
    for cloud, (x, m) in clouds.items():
        tx, tm = torch.from_numpy(x), torch.from_numpy(m)
        for path, fn in paths.items():
            if cloud == "KNIFE" and path == "cellgraph":
                continue
            got = fn(tx.to(device), tm.to(device))
            want = fn(tx, tm)
            for f in ("labels", "num_clusters", "overflow"):
                if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
                    raise AssertionError(f"knife {cloud} {path}: {f} CUDA "
                                         f"!= CPU")
            if int(got.overflow):
                raise AssertionError(f"knife {cloud} {path}: overflow")
            lab = got.labels.cpu().numpy()
            if cloud == "KNIFE":
                if kc.knife_linked(lab) != (True, True, False, False):
                    raise AssertionError(f"KNIFE {path}: "
                                         f"{kc.knife_linked(lab)}")
                continue
            col = kc.PATHS.index(path)
            for screen, case in cases.items():
                if kc.linked(lab, case) != kc.PORT_LINKED[screen][col]:
                    raise AssertionError(f"knife {screen} on {path}: "
                                         f"{kc.linked(lab, case)}")
    release_all_graphs()      # the bands' graph; the probes need none
    log(f"knife edge: KNIFE rows and {len(cases)} screens' pairs, CUDA == "
        f"CPU bit for bit on stixel, cellgraph (cell_capacity "
        f"{CELL_CAPACITY}) and 2 bands (on the card its graph); verdicts as "
        f"stored")


def frame0_debug(device):
    """Synthetic frame 0 at DEFAULT_CONFIG through cluster_debug on the
    card, recording the arguments of its two tier_min_d2 calls (intra,
    then supernode pairs; frame 0's, without the batch axis). Returns
    (result, debug dict, calls)."""
    import torch
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG as cfg
    from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
    from lidar_processing_tpu_torch.ops import stixel as sx
    from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
    from lidar_processing_tpu_torch.types import SEG_OBSTACLE

    xyz, _ = street_scene(0)
    x, m = (torch.from_numpy(a).to(device)
            for a in pad_frame(xyz, cfg.pipeline.max_points))
    seg = gpf_segment(x, m, cfg.segmentation)
    calls, kernel = [], sx.tier_min_d2

    def recording(*args):
        # the step runs frame 0 as a batch of one: keep its own arrays
        calls.append((*(a[0] for a in args[:5]), *args[5:]))
        return kernel(*args)

    sx.tier_min_d2 = recording
    try:
        res, dbg = sx.cluster_debug(x, m & (seg.labels == SEG_OBSTACLE),
                                    cfg.clustering, cfg.pipeline)
    finally:
        sx.tier_min_d2 = kernel
    if int(res.overflow) != 0:
        raise AssertionError(f"frame 0 overflow {int(res.overflow)}")
    if len(calls) != 2:
        raise AssertionError(f"frame 0: {len(calls)} tier passes, not 2")
    return res, dbg, calls


def check_real_frame(device, res, dbg):
    """Frame 0's cluster_debug output: its supernode edge list through
    every union-find variant (all equal to the twin) and its ambiguous
    supernode pairs with u <= 8 and v <= 96 points (u the smaller side)
    in the planar (1, 3n) layout through the pair kernel and through the
    clustering path's old _stacked_windows
    + min_d2_planar (bit for bit), each by timing(). Returns the edge list
    for the probe path and (points (n, 3), us, uc, vs, vc) of the pairs
    as numpy, for parent_turns."""
    import torch
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG as cfg
    from lidar_processing_tpu_torch.kernels import probe_uf as puf
    from lidar_processing_tpu_torch.kernels.min_d2 import min_d2_planar
    from lidar_processing_tpu_torch.kernels.probe_pairs import (
        pair_min_d2_v96, planar)
    from lidar_processing_tpu_torch.kernels.tier_min_d2 import (
        F_BIG, _stacked_windows)
    from lidar_processing_tpu_torch.kernels.union_find import (cc_labels,
                                                               cc_labels_ref)

    s = cfg.pipeline.max_supernodes
    eu, ev, ne = dbg["e_u"], dbg["e_v"], dbg["n_edges"]
    euv = puf.pack_edges(eu, ev)
    variants = {"union_find": lambda: cc_labels(eu, ev, ne, s),
                "twin": lambda: cc_labels_ref(eu, ev, ne, s)}
    for name in puf.VARIANTS:
        fn = getattr(puf, name)
        variants[name] = ((lambda fn=fn: fn(euv, ne, s))
                          if name.startswith("uf_packed")
                          else (lambda fn=fn: fn(eu, ev, ne, s)))
    want = dbg["labels"]
    for name, fn in variants.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"frame 0 edges: {name} differs")
    log(f"frame 0 (cluster_debug, {int(dbg['n_snp'])} supernode pairs, "
        f"{int(res.num_clusters)} clusters): {int(ne)} edges over {s} "
        f"supernodes, every variant equal ({', '.join(variants)}; timed by "
        f"check_uf_probes)")

    sn, snp = dbg["sn"], cfg.pipeline.max_sn_pairs
    amb = ((torch.arange(snp, device=device) < dbg["n_snp"])
           & ~dbg["impossible"] & ~dbg["certain"])
    pu, pv = dbg["pu"].long(), dbg["pv"].long()
    us_, uc_, vs_, vc_ = sn.start[pu], sn.count[pu], sn.start[pv], sn.count[pv]
    swap = uc_ > vc_
    us, uc = torch.where(swap, vs_, us_), torch.where(swap, vc_, uc_)
    vs, vc = torch.where(swap, us_, vs_), torch.where(swap, uc_, vc_)
    keep = amb & (uc <= 8) & (vc <= 96)
    runs = tuple(t[keep].contiguous() for t in (us, uc, vs, vc))
    n_pairs = int(keep.sum())
    if n_pairs == 0:
        raise AssertionError("frame 0 has no small ambiguous pairs")
    sp_xyz = dbg["sp"].xyz
    points, lanes = planar(sp_xyz), sp_xyz.shape[0]

    def windows():
        pu_w = _stacked_windows(sp_xyz, runs[0], runs[1], F_BIG, 8, sr=8)
        pv_w = _stacked_windows(sp_xyz, runs[2], runs[3], -F_BIG, 96, sr=32)
        return min_d2_planar(*pu_w, *pv_w)

    calls = {"pair kernel": lambda: pair_min_d2_v96(points, lanes, *runs)}
    want = windows()
    for call, fn in calls.items():
        got = fn()
        if not torch.equal(got, want):
            raise AssertionError(f"frame 0 pairs, {call}: "
                                 f"{int((got != want).sum())} differ from "
                                 f"_stacked_windows + min_d2_planar")
    b = pair_bound(*(t.cpu().numpy() for t in runs), 96, lanes)
    log(f"frame 0 small ambiguous pairs: {n_pairs} of {int(amb.sum())} "
        f"(u <= 8, v <= 96), {int((runs[1] * runs[3]).sum())} point pairs, "
        f"the planar (1, 3n) layout of {lanes} points; pair kernel == "
        f"_stacked_windows + min_d2_planar bit for bit; bound {b['bound_ms']:.6f} ms ({b['bound_by']})")
    for call, fn in (*calls.items(), ("windows + min_d2", windows)):
        log(f"  {call}: {fmt_timing(timing(fn))}")
    frame_pairs = (sp_xyz.cpu().numpy(),
                   *(t.cpu().numpy() for t in runs))
    return (eu, ev, ne), frame_pairs


def parent_turns(frame_pairs, smi: str) -> None:
    """The pair kernels and slice_sum of a parent tree unpacked under
    build/parent (a `git archive` of an earlier commit) against this
    tree's, in turns (parent, change, change, parent;
    tools/kernel_bench.py), on the JAX probes' inputs, frame 0's small
    ambiguous pairs and slice_sum's sweep of n. Skipped without a parent
    tree."""
    from lidar_processing_tpu_torch.tools import kernel_bench
    if not (PARENT / "lidar_processing_tpu_torch").is_dir():
        log(f"parent turns: no parent tree under "
            f"{PARENT.relative_to(HERE)}; skipped")
        return
    kernel_bench.run_turns(
        [PARENT, HERE], kernel_bench.pair_inputs(frame_pairs),
        kernel_bench.slice_inputs(), turns=2,
        log=lambda m: log(f"parent turns ({smi}): {m}"))


PROBE_KERNELS = ("uf_probe", "uf_serial", "uf_packed", "uf_packed_noskip",
                 "pair_min_d2_v48", "pair_min_d2_v96", "gather_sum",
                 "slice_sum", "tile_scale")


def run_probe_path(device, edges) -> dict:
    """The probe entry points as a user runs them, the frame-0 edge list
    included; every probe kernel must have been launched by this run."""
    from lidar_processing_tpu_torch.kernels import probe_mosaic2 as m2
    from lidar_processing_tpu_torch.kernels import probe_pairs as pp
    from lidar_processing_tpu_torch.kernels import probe_uf as puf
    from lidar_processing_tpu_torch.tools import (probe_mosaic,
                                                  probe_mosaic2,
                                                  probe_mosaic3, probe_uf,
                                                  probe_uf2)
    wrappers = {w.__name__: w for w in (
        puf.uf_probe, puf.uf_serial, puf.uf_packed, puf.uf_packed_noskip,
        pp.pair_min_d2_v48, pp.pair_min_d2_v96, m2.gather_sum,
        m2.slice_sum, m2.tile_scale)}
    for w in wrappers.values():
        w.launches = 0
    probe_uf.main(device)
    probe_uf2.main(device)
    probe_uf2.main(device, edges=edges)
    probe_mosaic.main(device)
    probe_mosaic3.main(device)
    probe_mosaic2.main(device)
    launches = {name: w.launches for name, w in wrappers.items()}
    if sorted(launches) != sorted(PROBE_KERNELS) or not all(
            launches.values()):
        raise AssertionError(f"probe launches {launches}: a kernel did "
                             f"not run")
    log(f"probe path: launches {launches}")
    return launches


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
    end-to-end ms/frame, native route counts)."""
    import torch
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    from lidar_processing_tpu_torch.kernels.min_d2 import min_d2_planar
    from lidar_processing_tpu_torch.kernels.stamp import stamp
    from lidar_processing_tpu_torch.kernels.tier_min_d2 import tier_min_d2
    from lidar_processing_tpu_torch.kernels.union_find import cc_labels
    from lidar_processing_tpu_torch.ops.hull_native import chi_hulls_batch
    from lidar_processing_tpu_torch.runtime.compiled import WARMUP_STEPS
    from lidar_processing_tpu_torch.runtime.pipeline import STAGES
    from lidar_processing_tpu_torch.runtime.stream import (
        CALIBRATION_TRIES, ReplayStream)

    kernels = {"tier_min_d2": tier_min_d2, "union_find": cc_labels,
               "min_d2": min_d2_planar, "stamp": stamp}
    for fn in kernels.values():
        fn.launches = 0
    stream = ReplayStream(DEFAULT_CONFIG, data_dir=str(tmp), device=device)
    errors = []                           # each calibration's error (ns)
    calibrate = stream.calibrate

    def calibrate_counted():
        calibrate()
        errors.append(stream.clock_error_ns)
    stream.calibrate = calibrate_counted
    stream.warmup()                       # first run: capture, kernel build
    t0 = time.perf_counter()
    stream.warmup()
    warm_s = time.perf_counter() - t0

    graph = stream.graph
    if graph is None:
        raise AssertionError("ReplayStream did not run on the compiled step")
    chi_hulls_batch.calls = chi_hulls_batch.fallbacks = 0
    torch.cuda.reset_peak_memory_stats(device)
    graph.replays = 0
    t0 = time.perf_counter()
    results = list(stream.run(N_FRAMES))  # run() warms up with one step
    run_s = time.perf_counter() - t0
    wrapped = {name: fn.launches for name, fn in kernels.items()}
    nodes = {name: graph.kernel_nodes(k) for name, k in KERNEL_OF.items()}
    launches = {name: n * graph.replays for name, n in nodes.items()}
    route = {"chi_hulls_batch": chi_hulls_batch.calls,
             "fallbacks": chi_hulls_batch.fallbacks}
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
    # from Python: the warm-up steps and the capture, then replays only;
    # a stamp a stage boundary, and each calibration's bracketed stamps
    calls = WARMUP_STEPS + 1
    stamps = len(STAGES) + 1
    want = {"tier_min_d2": 2 * calls, "union_find": calls, "min_d2": 0,
            "stamp": stamps * calls + CALIBRATION_TRIES * len(errors)}
    if wrapped != want:
        raise AssertionError(f"the wrappers launched {wrapped} from Python, "
                             f"expected {want}")
    check_kernel_nodes(graph, {"tier_min_d2": 2, "union_find": 1,
                               "min_d2": 0, "stamp": stamps},
                       "the main path's graph")
    if graph.replays != N_FRAMES + WARMUP_FRAMES:
        raise AssertionError(f"{graph.replays} replays for "
                             f"{N_FRAMES + WARMUP_FRAMES} steps")
    if route["chi_hulls_batch"] != N_FRAMES:
        raise AssertionError(f"{route['chi_hulls_batch']} native "
                             f"chi_hulls_batch calls for {N_FRAMES} frames")
    calibrations = len(errors)
    check_stamps(stream, results, max(errors))   # replays frame 0 again
    log(f"main path: {N_FRAMES} frames + {WARMUP_FRAMES} warmup through "
        f"ReplayStream on its compiled step (captured in "
        f"{graph.capture_s:.3f} s, pool {graph.pool_bytes / 2**20:.0f} "
        f"MiB); wrappers' launches from Python (counts set to 0 before the "
        f"stream was built; stamp's include {calibrations} calibrations of "
        f"{CALIBRATION_TRIES}) {wrapped}; the graph's kernel nodes {nodes} x "
        f"{graph.replays} replays in the run = launches {launches}; host "
        f"outlines: "
        f"{route['chi_hulls_batch']} native chi_hulls_batch calls, "
        f"{route['fallbacks']} degenerate clusters sent down the single "
        f"chain; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.0f} MiB")
    return stream, results, launches, e2e_ms, route


def check_stamps(stream, results, error_ns: int) -> None:
    """The stamps the main path's frames carry: on every delivered frame
    the four device stages each take some time, the first stamp falls
    after the dispatch began and the last before the wait on the payload
    ended, both mapped onto the host clock within the largest
    calibration error and STAMP_SLACK_NS; then frame 0's stats row,
    replayed again, holds its five rising stamps in columns 0-4 inside
    the host's bracket around the replay and its counters in the columns
    after them, equal to the run's and to cluster_debug's counts."""
    import torch
    from lidar_processing_tpu_torch.ops import stixel as tsx
    from lidar_processing_tpu_torch.ops.segmentation import (
        gpf_segment_sorted)
    from lidar_processing_tpu_torch.runtime.pipeline import (COUNTERS,
                                                             STAGES)
    from lidar_processing_tpu_torch.types import SEG_OBSTACLE
    slack_s = (error_ns + STAMP_SLACK_NS) * 1e-9
    for _, m in results:
        span = {n: (a, b) for n, a, b in m.spans}
        if sorted(m.device_ms) != sorted(STAGES) or min(
                m.device_ms.values()) <= 0.0:
            raise AssertionError(f"frame {m.frame_id}: device stages "
                                 f"{m.device_ms}")
        first, last = span[STAGES[0]][0], span[STAGES[-1]][1]
        if not (span["stream.dispatch"][0] - slack_s <= first
                and last <= span["stream.device_wait"][1] + slack_s):
            raise AssertionError(
                f"frame {m.frame_id}: stamps mapped to [{first:.6f}, "
                f"{last:.6f}] s outside the dispatch's start "
                f"{span['stream.dispatch'][0]:.6f} s and the wait's end "
                f"{span['stream.device_wait'][1]:.6f} s (slack "
                f"{slack_s * 1e6:.1f} us)")
    cfg = stream.config
    stream.calibrate()
    a = time.perf_counter_ns()
    _, row = stream._step(0)
    row = row.tolist()
    b = time.perf_counter_ns()
    at = [t - stream.clock_offset_ns for t in row[:len(STAGES) + 1]]
    slack = stream.clock_error_ns + STAMP_SLACK_NS
    if not (a - slack <= at[0] and all(y > x for x, y in zip(at, at[1:]))
            and at[-1] <= b + slack):
        raise AssertionError(f"frame 0's stamps {row[:len(STAGES) + 1]} "
                             f"(host {at} ns) do not rise inside the "
                             f"replay's bracket [{a}, {b}] ns")
    ss = gpf_segment_sorted(stream.xyz[0], stream.mask[0], cfg.segmentation)
    _, dbg = tsx.cluster_debug(ss.xyz, ss.valid & (
        ss.labels == SEG_OBSTACLE), cfg.clustering, cfg.pipeline)
    counts = dict(zip(COUNTERS, row[len(STAGES) + 1:]))
    debug = {"tier_pairs": int(dbg["tiers1"][:-1].sum()
                               + dbg["tiers2"][:-1].sum()),
             "uf_edges": int(dbg["n_edges"])}
    ran = next(m.counters for _, m in results if m.frame_id == 0)
    if counts != ran or any(counts[k] != v for k, v in debug.items()):
        raise AssertionError(f"frame 0's counters {counts}, in the run "
                             f"{ran}, cluster_debug's {debug}")
    torch.cuda.synchronize()
    med = {n: float(np.median([m.device_ms[n] for _, m in results]))
           for n in STAGES}
    log(f"stamps: {len(results)} frames, each stage > 0 and both ends "
        f"inside the host's bracket within {slack_s * 1e6:.1f} us; device "
        f"stages p50 {med} ms; frame 0's row {row} (stamps in columns "
        f"0-{len(STAGES)}, counters {counts} = cluster_debug's {debug})")


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


def check_against_radius_cc(device, backend: str = "stixel") -> int:
    """A small scene through the device step on the card, on `backend`:
    its cluster labels must equal an independent reference — exact
    connected components of the d <= sqrt(distance_squared) graph over
    the obstacle points (scipy), size-filtered and numbered by min point
    index — with overflow 0."""
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
        max_column_pairs=8192, max_sn_pairs=8192, max_ambiguous_pairs=8192,
        clustering_backend=backend))
    xyz, _ = street_scene(0, "small")
    x, m = pad_frame(xyz, 4096)
    fr = device_frame_step(torch.from_numpy(x).to(device),
                           torch.from_numpy(m).to(device), cfg)
    if int(fr.clustering.overflow) != 0:
        raise AssertionError(f"small scene ({backend}): overflow "
                             f"{int(fr.clustering.overflow)}")
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
        raise AssertionError(f"radius-CC reference ({backend}): "
                             f"{np.sum(got != want)} labels differ")
    log(f"small scene on the card ({backend}): cluster labels == exact "
        f"radius-CC reference ({int(keep.sum())} clusters, {len(obst)} "
        f"obstacles)")
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
    log(f"host syncs in one device step "
        f"({stream.config.pipeline.clustering_backend}): {len(syncs)}"
        + "".join(f"\n  at {m}" for m in sorted(set(syncs))))
    if syncs:
        raise AssertionError("the device step waits on the card")
    return len(syncs)


def time_frames(stream, results, device):
    """p50 device ms/frame (CUDA events around the stream's step, the
    compiled step's replay) and p50 host ms/frame (the stream's host
    decode + outlines)."""
    dev_ms = []
    for fid in range(stream.num_frames):
        dev_ms.append(cuda_ms(lambda: stream._step(fid), reps=3))
    host_ms = [m.t_host_ms for _, m in results]
    return statistics.median(dev_ms), statistics.median(host_ms)


def large_slices(fr):
    """A FrameResult's large-cluster xy runs, as host_outputs slices them."""
    sorted_xyz = fr.runs.sorted_xyz.cpu().numpy()
    starts, counts = fr.runs.starts.cpu().numpy(), fr.runs.counts.cpu().numpy()
    ids = fr.large_ids.cpu().numpy()[:int(fr.n_large)]
    return [sorted_xyz[starts[c]:starts[c] + counts[c], :2] for c in ids]


def scipy_outlines(slices, config):
    """The host stage's plain reference: the scipy chain per cluster."""
    from lidar_processing_tpu_torch.ops.host_hulls import chi_concave_hull
    return [chi_concave_hull(xy, config.polygonization.chi) for xy in slices]


def replay(stream, n: int, **kw):
    """(end-to-end ms/frame less one warmup step, host p50 ms, metrics) of
    an n-frame ReplayStream run."""
    stream.warmup()
    t0 = time.perf_counter()
    stream.warmup()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = list(stream.run(n, **kw))
    run_s = time.perf_counter() - t0
    return ((run_s - warm_s) * 1e3 / n,
            statistics.median(m.t_host_ms for _, m in results),
            [m for _, m in results])


def check_broken_build(slices, config) -> str:
    """With the host module's source broken, the host stage must raise
    (g++'s log in the message) and never reach the scipy chain."""
    from lidar_processing_tpu_torch.native import _build as native
    from lidar_processing_tpu_torch.ops import hull_native
    from lidar_processing_tpu_torch.runtime import pipeline as pipe

    def scipy_reached(*args):
        raise AssertionError("the host stage fell back to scipy")

    saved = (native.SOURCE, native.BUILD_DIR, hull_native._oracle_chain)
    with tempfile.TemporaryDirectory() as tmp:
        native.SOURCE = Path(tmp) / "lidar_native.cpp"
        native.SOURCE.write_text("int broken( {\n")
        native.BUILD_DIR = Path(tmp) / "build"
        hull_native._oracle_chain = scipy_reached
        native.build.cache_clear()
        native.library.cache_clear()
        try:
            pipe._outlines_from_slices(slices, config)
        except RuntimeError as e:
            message = str(e)
        else:
            raise AssertionError("a broken native build did not raise")
        finally:
            native.SOURCE, native.BUILD_DIR, hull_native._oracle_chain = saved
            native.build.cache_clear()
            native.library.cache_clear()
    if not message.startswith("g++ failed"):
        raise AssertionError(f"broken build raised {message[:200]!r}")
    native.library()
    return message.splitlines()[0]


def check_host_stage(tmp: Path, stream, route, native_s, smi) -> None:
    """The host stage and the entry points on the card (see the module
    docstring, phase 7)."""
    from lidar_processing_tpu_torch import cli
    from lidar_processing_tpu_torch.io.export import read_ply_xyzrgb
    from lidar_processing_tpu_torch.oracle.diff import polygon_chamfer
    from lidar_processing_tpu_torch.runtime import pipeline as pipe
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream
    from lidar_processing_tpu_torch.tools.golden_run import DEFAULT_OUT
    cfg = stream.config
    log(f"host stage: native module built in {native_s:.2f} s; the main "
        f"path made {route['chi_hulls_batch']} chi_hulls_batch calls for "
        f"{N_FRAMES} frames, {route['fallbacks']} per-cluster fallbacks")

    # frame 0's large clusters: native against the scipy chain
    fr = pipe.device_frame_step(stream.xyz[0], stream.mask[0], cfg)
    slices = large_slices(fr)
    t0 = time.perf_counter()
    nat = pipe._outlines_from_slices(slices, cfg)
    t_nat = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = scipy_outlines(slices, cfg)
    t_ref = (time.perf_counter() - t0) * 1e3
    chamfer = [polygon_chamfer(a, b) for a, b in zip(nat, ref)]
    if len(nat) != len(slices) or max(chamfer) >= 0.05:
        raise AssertionError(f"frame 0 native outlines: {len(nat)} for "
                             f"{len(slices)} clusters, worst chamfer "
                             f"{max(chamfer)}")
    out = pipe.host_outputs(fr, cfg, int(stream.counts[0]))
    if len(out.outlines) != out.num_clusters:
        raise AssertionError(f"frame 0: {len(out.outlines)} outlines for "
                             f"{out.num_clusters} clusters")
    log(f"frame 0: {len(slices)} large clusters "
        f"({sum(len(x) for x in slices)} points), native chi_hulls_batch "
        f"{t_nat:.1f} ms vs the scipy chain {t_ref:.1f} ms; chamfer "
        f"native vs scipy max {max(chamfer):.5f} m, mean "
        f"{statistics.mean(chamfer):.5f} m; {len(out.outlines)} outlines "
        f"== {out.num_clusters} clusters")
    log(f"broken native build: raises ({check_broken_build(slices, cfg)}), "
        f"never reaches scipy")

    # the same 8 frames through both routes, native first
    nat_e2e, nat_host, _ = replay(stream, N_FRAMES)
    saved = pipe._outlines_from_slices
    pipe._outlines_from_slices = scipy_outlines
    try:
        ref_e2e, ref_host, _ = replay(stream, N_FRAMES)
    finally:
        pipe._outlines_from_slices = saved
    log(f"host route ({smi}; host CPU {host_cpu()}), {N_FRAMES} frames: "
        f"native host p50 {nat_host:.2f} ms, end to end {nat_e2e:.2f} ms; "
        f"scipy host p50 {ref_host:.2f} ms, end to end {ref_e2e:.2f} ms")

    # the stage-timed replay on its two stage graphs, the eager stages
    # beside it
    _, _, timed = replay(stream, 2, stage_timing=True)
    stages = stream.stage_graphs
    if len(stages) != 2:
        raise AssertionError(f"the stage-timed replay ran {len(stages)} "
                             f"stage graphs, not 2")
    for what, step, n in (("segmentation", stages[0], 0),
                          ("clustering", stages[1], 1)):
        check_kernel_nodes(step, {"tier_min_d2": 2 * n, "union_find": n,
                                  "min_d2": 0, "stamp": 0},
                           f"the {what} stage's graph")
    eager = ReplayStream(cfg, data_dir=str(tmp), device=stream.device,
                         eager=True)
    _, _, eager_timed = replay(eager, 2, stage_timing=True)
    del eager
    for m, e in zip(timed, eager_timed):
        if None in (m.t_seg_ms, m.t_cluster_ms, m.t_hull_ms, e.t_seg_ms):
            raise AssertionError("stage-timed replay left a stage untimed")
        log(f"stage-timed frame {m.frame_id} ({smi}): on the stage graphs "
            f"seg {m.t_seg_ms:.2f} ms, cluster {m.t_cluster_ms:.2f} ms, "
            f"hull {m.t_hull_ms:.2f} ms (dispatch {m.t_dispatch_ms:.2f} ms); "
            f"eager seg {e.t_seg_ms:.2f} ms, cluster {e.t_cluster_ms:.2f} "
            f"ms, hull {e.t_hull_ms:.2f} ms (dispatch "
            f"{e.t_dispatch_ms:.2f} ms)")
    log("stage graphs: " + "; ".join(graph_line(k, g) for k, g in zip(
        ("segment_stage", "cluster_stage"), stages)))

    # paced at the sensor's period, as `run --realtime` replays
    _, _, paced = replay(stream, N_FRAMES, realtime=True)
    log(f"realtime replay ({stream.config.pipeline.replay_rate_hz:g} Hz), "
        f"{N_FRAMES} frames: dispatch p50 "
        f"{statistics.median(m.t_dispatch_ms for m in paced):.2f} ms, host "
        f"p50 {statistics.median(m.t_host_ms for m in paced):.2f} ms, "
        f"{sum(m.deadline_missed for m in paced)} deadline misses, "
        f"{sum(m.frames_dropped for m in paced)} frames dropped")

    # the CLI: run with an export, golden (must pass), bench
    export = tmp / "export"
    if cli.main(["run", "--data-dir", str(tmp), "--export-dir", str(export),
                 "--export-frames", "0"]) != 0:
        raise AssertionError("cli run failed")
    plys = sorted(export.glob("frame_0000_*.ply"))
    polys = json.loads((export / "frame_0000_polygons.json").read_text())
    if len(plys) != 3 or not all(read_ply_xyzrgb(str(p))[0].shape[0]
                                 for p in plys) or not polys["polygons"]:
        raise AssertionError(f"cli run export: {plys}")
    log(f"cli run: exported {[p.name for p in plys]} (PLY headers parse) "
        f"and {len(polys['polygons'])} polygons")
    if cli.main(["golden", "--data-dir", str(tmp), "--frames", "2"]) != 0:
        raise AssertionError("cli golden failed on 2 frames")
    bench = cli.main(["bench", "--data-dir", str(tmp), "--golden",
                      str(DEFAULT_OUT)])
    if bench != 0:
        raise AssertionError("cli bench failed")


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (floats compared as their int32 words,
    so a NaN equals itself)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def run_batched_path(stream):
    """The batched step over the 8 frames (module docstring, phase 7).
    Returns the B = 8 step's kernel calls: {kernel name: [args]}."""
    import functools
    import torch
    from lidar_processing_tpu_torch.kernels.tier_min_d2 import tier_min_d2
    from lidar_processing_tpu_torch.kernels.union_find import cc_labels
    from lidar_processing_tpu_torch.ops import stixel as sx
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_batched, pack_host_payload)
    from lidar_processing_tpu_torch.types import frame_of
    cfg, dev = stream.config, stream.device
    x, m = stream.xyz[:N_FRAMES], stream.mask[:N_FRAMES]

    def step(lo: int, b: int):
        fr = device_frame_step_batched(x[lo:lo + b], m[lo:lo + b], cfg)
        return fr, pack_host_payload(fr, cfg)

    ref = [step(f, 1) for f in range(N_FRAMES)]
    launches = {}
    for b in BATCHES:
        tier_min_d2.launches = cc_labels.launches = 0
        outs = [step(lo, b) for lo in range(0, N_FRAMES, b)]
        launches[b] = {"tier_min_d2": tier_min_d2.launches,
                       "union_find": cc_labels.launches}
        steps = N_FRAMES // b
        if launches[b] != {"tier_min_d2": 2 * steps, "union_find": steps}:
            raise AssertionError(f"B={b}: {steps} batched steps launched "
                                 f"{launches[b]}")
        for lo, (fr, pay) in zip(range(0, N_FRAMES, b), outs):
            for k in range(b):
                want_fr, want_pay = ref[lo + k]
                pairs = zip(torch.utils._pytree.tree_leaves(frame_of(fr, k)),
                            torch.utils._pytree.tree_leaves(want_fr))
                if not all(same_bits(g, w[0]) for g, w in pairs):
                    raise AssertionError(f"B={b}: frame {lo + k}'s "
                                         f"FrameResult differs from B=1")
                if not same_bits(pay[k], want_pay[0]):
                    raise AssertionError(f"B={b}: frame {lo + k}'s payload "
                                         f"differs from B=1")
    log(f"batched step: every frame's FrameResult leaves and payload words "
        f"at B={'/'.join(map(str, BATCHES))} == B=1 bit for bit; launches "
        + "; ".join(f"B={b} ({N_FRAMES // b} steps): {n}"
                    for b, n in launches.items()))

    ms, peak = {}, {}
    for b in (1,) + BATCHES:
        calls = [functools.partial(device_frame_step_batched, x[lo:lo + b],
                                   m[lo:lo + b], cfg)
                 for lo in range(0, N_FRAMES, b)]
        calls[0]()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for call in calls:
                call()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / N_FRAMES)
        ms[b] = best
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        calls[0]()
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated(dev)
        peak[b] = (top, top - before)
    log(f"batched step, ms per frame (CUDA events, best of 3 passes over "
        f"the {N_FRAMES} frames): "
        + ", ".join(f"B={b} {t:.3f} ms" for b, t in ms.items())
        + "; peak device memory of one step (its own): "
        + ", ".join(f"B={b} {p / 2**20:.0f} MiB ({own / 2**20:.0f} MiB)"
                    for b, (p, own) in peak.items()))

    # the B = 8 step's kernel calls, for the kernels-vs-twins phase
    calls = {"tier_min_d2": [], "union_find": []}
    kernels = (sx.tier_min_d2, sx.cc_labels)

    def recording(name, fn):
        def record(*args):
            calls[name].append(args)
            return fn(*args)
        return record

    sx.tier_min_d2 = recording("tier_min_d2", kernels[0])
    sx.cc_labels = recording("union_find", kernels[1])
    try:
        device_frame_step_batched(x, m, cfg)
    finally:
        sx.tier_min_d2, sx.cc_labels = kernels
    if (len(calls["tier_min_d2"]), len(calls["union_find"])) != (2, 1):
        raise AssertionError(f"B={N_FRAMES} step: {calls} kernel calls")
    return calls


def check_batched_kernels(calls) -> None:
    """Both main-path kernels' batched launches on frames 0-7's own calls
    (the B = 8 step's) against 8 single launches and the batched twins,
    bit for bit; CUDA-event and profiler times of the batched launch
    beside the single launches', and its bound."""
    from lidar_processing_tpu_torch.kernels.tier_min_d2 import (
        tier_min_d2, tier_min_d2_ref)
    from lidar_processing_tpu_torch.kernels.union_find import (cc_labels,
                                                               cc_labels_ref)
    for name, fn, twin in (("tier_min_d2", tier_min_d2, tier_min_d2_ref),
                           ("union_find", cc_labels, cc_labels_ref)):
        for i, args in enumerate(calls[name]):
            n_in, rest = len(args) - 1, args[-1:]
            frames = args[0].shape[0]
            got = fn(*args)
            if not same_bits(got, twin(*args)):
                raise AssertionError(f"{name} B={frames} call {i}: differs "
                                     f"from the batched twin")
            singles = [lambda b=b: fn(*(a[b] for a in args[:n_in]), *rest)
                       for b in range(frames)]
            if not all(same_bits(got[b], one()) for b, one in
                       enumerate(singles)):
                raise AssertionError(f"{name} B={frames} call {i}: differs "
                                     f"from {frames} single launches")
            t = (cuda_ms(lambda: fn(*args)), device_ms(lambda: fn(*args)))
            t1 = (cuda_ms(lambda: [one() for one in singles]),
                  device_ms(lambda: [one() for one in singles]))
            if name == "tier_min_d2":
                work = np.sum([tier_work([a[b] for a in args[:n_in]],
                                         args[-1]) for b in range(frames)], 0)
                b_ = bound(*work)
            else:
                b_ = uf_bound(int(args[2].sum()), 8, args[-1])
            log(f"{name} B={frames} (frames 0-{frames - 1}'s call {i}): one "
                f"launch == {frames} single launches == the batched twin, "
                f"bit for bit; one launch {t[0]:.4f} ms (device "
                f"{fmt_ms(t[1])}, warm {warm_ms(lambda: fn(*args)):.4f} ms, "
                f"host {host_us(lambda: fn(*args)):.2f} us), {frames} single "
                f"launches {t1[0]:.4f} ms (device {fmt_ms(t1[1])}), bound "
                f"{b_['bound_ms']:.6f} ms ({b_['bound_by']})")


def log_step_kernels(stream) -> dict:
    """torch.profiler's count of the CUDA kernels in one device step of
    frame 0 (at most KERNELS_B1_MAX) and in one batched step of frames
    0-7, with their summed device time."""
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_packed, device_frame_step_packed_batched)
    from lidar_processing_tpu_torch.tools.step_bench import step_kernels
    out = step_kernels(lambda: device_frame_step_packed(
        stream.xyz[0], stream.mask[0], stream.config))
    out8 = step_kernels(lambda: device_frame_step_packed_batched(
        stream.xyz[:N_FRAMES], stream.mask[:N_FRAMES], stream.config))
    log(f"one device step (torch.profiler): B=1 (frame 0) {out['kernels']} "
        f"CUDA kernels, {out['copies']} copies and fills, "
        f"{out['busy_ms']:.3f} ms of device time; B={N_FRAMES} (frames 0-"
        f"{N_FRAMES - 1}) {out8['kernels']} CUDA kernels, {out8['copies']} "
        f"copies and fills, {out8['busy_ms']:.3f} ms of device time "
        f"({out8['busy_ms'] / N_FRAMES:.3f} ms a frame)")
    if out["kernels"] > KERNELS_B1_MAX:
        raise AssertionError(f"a B=1 step ran {out['kernels']} CUDA "
                             f"kernels, more than {KERNELS_B1_MAX}")
    return {1: out, N_FRAMES: out8}


def step_and_payload(xyzs, masks, config):
    """The batched step and its payloads, the graph phase's capture."""
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_batched, pack_host_payload)
    fr = device_frame_step_batched(xyzs, masks, config)
    return fr, pack_host_payload(fr, config)


def check_graph_steps(stream) -> None:
    """Replays against eager steps, bit for bit, with the kernel nodes of
    each graph (module docstring, phase 8b)."""
    import torch
    from lidar_processing_tpu_torch.kernels.min_d2 import min_d2_planar
    from lidar_processing_tpu_torch.kernels.tier_min_d2 import tier_min_d2
    from lidar_processing_tpu_torch.kernels.union_find import cc_labels
    from lidar_processing_tpu_torch.runtime.compiled import CompiledStep
    wrappers = (tier_min_d2, cc_labels, min_d2_planar)
    x, m = stream.xyz[:N_FRAMES], stream.mask[:N_FRAMES]
    for backend, cfg, batches, want in (
            ("stixel", stream.config, (1,) + BATCHES,
             {"tier_min_d2": 2, "union_find": 1, "min_d2": 0, "stamp": 0}),
            ("cellgraph", cellgraph_config(), (1, N_FRAMES),
             {"tier_min_d2": 0, "union_find": 0, "min_d2": 0,
              "stamp": 0})):
        for b in batches:
            step = CompiledStep(step_and_payload, cfg, b, stream.device)
            check_kernel_nodes(step, want, f"{backend} B={b}")
            for lo in range(0, N_FRAMES, b):
                for fn in wrappers:
                    fn.launches = 0
                got = step(x[lo:lo + b], m[lo:lo + b])
                if any(fn.launches for fn in wrappers):
                    raise AssertionError(f"{backend} B={b}: a replay "
                                         f"launched kernels from Python")
                ref = step_and_payload(x[lo:lo + b], m[lo:lo + b], cfg)
                for i, (g, w) in enumerate(zip(
                        torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(ref))):
                    if not same_bits(g, w):
                        raise AssertionError(
                            f"{backend} B={b} frames {lo}-{lo + b - 1}: leaf "
                            f"{i} of the replay differs from the eager step")
            log(f"compiled step, {backend} B={b}: every replay over frames "
                f"0-{N_FRAMES - 1} == the eager step bit for bit (FrameResult "
                f"leaves and payload words); its graph holds {want} kernel "
                f"nodes, and replays launched nothing from Python; capture "
                f"{step.capture_s:.3f} s, pool {step.pool_bytes / 2**20:.0f} "
                f"MiB")
            step.release()
            del step, got, ref
            torch_empty_cache()


def check_kernel_nodes(step, want: dict, what: str) -> None:
    """A CompiledStep's graph holds `want` kernel nodes ({wrapper name:
    nodes} of KERNEL_OF's kernels); a mismatch shows a kernel node of the
    graph's DOT print."""
    from lidar_processing_tpu_torch.runtime.compiled import dot_nodes
    got = {name: step.kernel_nodes(k) for name, k in KERNEL_OF.items()}
    if got != want:
        nodes = dot_nodes(step.dot())
        sample = next((n for n in nodes if "KERNEL" in n), nodes[:1])
        raise AssertionError(f"{what}: kernel nodes {got}, not {want}; "
                             f"{len(nodes)} nodes, e.g. {str(sample)[:600]}")


def check_graph_launches(stream) -> None:
    """torch.profiler on the main path's graph (the stream's B = 1 packed
    step): one cudaGraphLaunch and no kernel launch call a step, against
    the eager step's launch calls; a replay runs each hand kernel as many
    times as the graph holds nodes of it."""
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_packed)
    from lidar_processing_tpu_torch.tools.step_bench import step_kernels
    x, m, cfg = stream.xyz[0], stream.mask[0], stream.config
    eager = step_kernels(lambda: device_frame_step_packed(x, m, cfg))
    graph = step_kernels(lambda: stream._step(0))
    if (graph["graph_launches"], graph["launch_calls"]) != (1, 0):
        raise AssertionError(f"a replayed step: {graph}")
    _, ran = kernel_counts(lambda: stream._step(0))
    inside = {k: launches_of(ran, k) for k in ("tier_min_d2_kernel",
                                               "union_find_kernel")}
    nodes = {k: stream.graph.kernel_nodes(k) for k in inside}
    if inside != nodes or nodes != {"tier_min_d2_kernel": 2,
                                    "union_find_kernel": 1}:
        raise AssertionError(f"a replay ran {inside}; its graph holds "
                             f"{nodes}")
    log(f"main path's graph (torch.profiler, frame 0): "
        f"{graph['graph_launches']} cudaGraphLaunch and "
        f"{graph['launch_calls']} kernel launch calls a "
        f"step, {graph['kernels']} CUDA kernels and {graph['copies']} copies "
        f"and fills inside, {graph['busy_ms']:.3f} ms of device time, "
        f"{inside} of them the hand kernels (== the graph's nodes); "
        f"the eager step: "
        f"{eager['launch_calls']} kernel launch calls, {eager['kernels']} "
        f"kernels, {eager['busy_ms']:.3f} ms")


def torch_empty_cache() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_graph_turns(stream, smi) -> None:
    """The compiled step's profiles and turns (module docstring, phase
    15b), on frames written anew."""
    from lidar_processing_tpu_torch.tools.step_bench import (format_routes,
                                                             route_turns)
    check_graph_launches(stream)
    with tempfile.TemporaryDirectory() as tmp:
        write_frames(Path(tmp))
        result = route_turns(Path(tmp), N_FRAMES)
    for name, res in result["cases"].items():
        launch = (res["graph"]["graph_launches"],
                  res["graph"]["launch_calls"])
        if launch != (1, 0):
            raise AssertionError(f"{name} graph: {launch} launch calls")
    log(f"eager against graph in turns ({smi}; host CPU {host_cpu()}):\n"
        + format_routes(result))


def cellgraph_config(capacity: int = CELL_CAPACITY):
    """DEFAULT_CONFIG at full width on the cellgraph backend."""
    import dataclasses
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    return DEFAULT_CONFIG.replace(pipeline=dataclasses.replace(
        DEFAULT_CONFIG.pipeline, clustering_backend="cellgraph",
        cell_capacity=capacity))


def run_cellgraph_path(tmp: Path, device, stixel_results):
    """The 8 frames through ReplayStream on the cellgraph backend
    (cell_capacity CELL_CAPACITY, nothing else cut): every frame overflow
    0, cluster labels and num_clusters equal to the stixel stream's bit
    for bit, one outline per cluster, and none of the stixel kernels
    launched; then each frame's overflow at the shipped cell_capacity."""
    from lidar_processing_tpu_torch.kernels.min_d2 import min_d2_planar
    from lidar_processing_tpu_torch.kernels.tier_min_d2 import tier_min_d2
    from lidar_processing_tpu_torch.kernels.union_find import cc_labels
    from lidar_processing_tpu_torch.runtime.pipeline import device_frame_step
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream

    stream = ReplayStream(cellgraph_config(), data_dir=str(tmp),
                          device=device)
    stream.warmup()
    kernels = {"tier_min_d2": tier_min_d2, "union_find": cc_labels,
               "min_d2": min_d2_planar}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = list(stream.run(N_FRAMES))
    run_s = time.perf_counter() - t0
    stream.release()      # the profiles below need no graph held
    launches = {name: fn.launches for name, fn in kernels.items()}
    stixel = {m.frame_id: out for out, m in stixel_results}
    for out, m in results:
        want = stixel[m.frame_id]
        if m.overflow != 0:
            raise AssertionError(f"cellgraph frame {m.frame_id}: overflow "
                                 f"{m.overflow}")
        if (out.num_clusters != want.num_clusters
                or not np.array_equal(out.cluster_labels,
                                      want.cluster_labels)):
            raise AssertionError(
                f"cellgraph frame {m.frame_id}: {out.num_clusters} clusters,"
                f" {np.sum(out.cluster_labels != want.cluster_labels)} "
                f"labels differ from the stixel stream's")
        if m.num_outlines != m.num_clusters:
            raise AssertionError(f"cellgraph frame {m.frame_id}: "
                                 f"{m.num_outlines} outlines")
    if any(launches.values()):
        raise AssertionError(f"the cellgraph path launched {launches}")
    ovf64 = [int(device_frame_step(stream.xyz[f], stream.mask[f],
                                   cellgraph_config(64)).clustering.overflow)
             for f in range(N_FRAMES)]
    log(f"cellgraph main path (cell_capacity {CELL_CAPACITY}): {N_FRAMES} "
        f"frames + 1 warmup through ReplayStream in {run_s:.1f} s, overflow "
        f"0 and cluster labels == the stixel stream's bit for bit on every "
        f"frame ({[out.num_clusters for out, _ in results]} clusters); "
        f"stixel kernels launched {launches}; overflow at the shipped "
        f"cell_capacity 64, frames 0-{N_FRAMES - 1}: {ovf64}")
    return stream


def check_cellgraph_cuda_vs_cpu(stream) -> None:
    """Frame 0: ops/clustering.py::cluster and label_runs on the card and
    on the CPU, from the same obstacle mask, bit for bit."""
    import torch
    from lidar_processing_tpu_torch.ops.clustering import cluster
    from lidar_processing_tpu_torch.ops.hull import label_runs
    from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
    from lidar_processing_tpu_torch.runtime.pipeline import NUM_SLOTS
    from lidar_processing_tpu_torch.types import SEG_OBSTACLE
    cfg = stream.config
    x, m = stream.xyz[0], stream.mask[0]
    obst = m & (gpf_segment(x, m, cfg.segmentation).labels == SEG_OBSTACLE)
    t0 = time.perf_counter()
    on_cpu = cluster(x.cpu(), obst.cpu(), cfg.clustering, cfg.pipeline)
    cpu_s = time.perf_counter() - t0
    on_gpu = cluster(x, obst, cfg.clustering, cfg.pipeline)
    for name, a, b in zip(on_gpu._fields, on_gpu, on_cpu):
        if not same_bits(a.cpu(), b):
            raise AssertionError(f"cellgraph cluster.{name}: CUDA and CPU "
                                 f"differ")
    runs_gpu = label_runs(x, on_gpu.labels, NUM_SLOTS)
    runs_cpu = label_runs(x.cpu(), on_cpu.labels, NUM_SLOTS)
    if not all(same_bits(a.cpu(), b) for a, b in zip(runs_gpu, runs_cpu)):
        raise AssertionError("label_runs: CUDA and CPU differ")
    log(f"cellgraph frame 0: cluster and label_runs on the card == on the "
        f"CPU bit for bit ({int(on_gpu.num_clusters)} clusters; the CPU "
        f"cluster took {cpu_s:.1f} s)")


def check_cellgraph_batched(stream):
    """One B = 8 cellgraph step over frames 0-7: every frame's FrameResult
    leaves and payload words equal its B = 1 step's, bit for bit."""
    import torch
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_batched, pack_host_payload)
    from lidar_processing_tpu_torch.types import frame_of
    cfg = stream.config
    x, m = stream.xyz[:N_FRAMES], stream.mask[:N_FRAMES]
    fr8 = device_frame_step_batched(x, m, cfg)
    pay8 = pack_host_payload(fr8, cfg)
    for f in range(N_FRAMES):
        fr1 = device_frame_step_batched(x[f:f + 1], m[f:f + 1], cfg)
        leaves = zip(torch.utils._pytree.tree_leaves(frame_of(fr8, f)),
                     torch.utils._pytree.tree_leaves(fr1))
        if not all(same_bits(g, w[0]) for g, w in leaves):
            raise AssertionError(f"cellgraph B={N_FRAMES}: frame {f}'s "
                                 f"FrameResult differs from B=1")
        if not same_bits(pay8[f], pack_host_payload(fr1, cfg)[0]):
            raise AssertionError(f"cellgraph B={N_FRAMES}: frame {f}'s "
                                 f"payload differs from B=1")
    log(f"cellgraph B={N_FRAMES} step: every frame's FrameResult leaves "
        f"and payload words == its B=1 step's bit for bit")


def measure_cellgraph(stream, smi) -> dict:
    """Kernels and device time of one cellgraph step (torch.profiler),
    device p50 at B = 1 (CUDA events around device_frame_step_packed, 3
    repeats a frame), ms per frame at B = 8 (CUDA events around the
    batched step, best of 3), and the peak memory of one step at B = 1
    and 8."""
    import torch
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_batched, device_frame_step_packed)
    from lidar_processing_tpu_torch.tools.step_bench import step_kernels
    cfg, dev = stream.config, stream.device
    x, m = stream.xyz[:N_FRAMES], stream.mask[:N_FRAMES]
    out = step_kernels(lambda: device_frame_step_packed(x[0], m[0], cfg))
    p50 = statistics.median(
        cuda_ms(lambda: device_frame_step_packed(x[f], m[f], cfg), reps=3)
        for f in range(N_FRAMES))
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        device_frame_step_batched(x, m, cfg)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / N_FRAMES)
    peak = {}
    for b in (1, N_FRAMES):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        device_frame_step_batched(x[:b], m[:b], cfg)
        torch.cuda.synchronize()
        peak[b] = torch.cuda.max_memory_allocated(dev) - before
    log(f"cellgraph step ({smi}): B=1 (frame 0) {out['kernels']} CUDA "
        f"kernels, {out['copies']} copies and fills, {out['busy_ms']:.3f} "
        f"ms of device time (torch.profiler); device p50 B=1 {p50:.3f} ms; "
        f"ms_per_frame B={N_FRAMES} {best:.3f} ms (best of 3); peak device "
        f"memory of one step, its own: B=1 {peak[1] / 2**20:.0f} MiB, "
        f"B={N_FRAMES} {peak[N_FRAMES] / 2**20:.0f} MiB")
    log("cellgraph step B=1, device time by op (torch.profiler, the "
        "kernels each op launched): " + top_ops(
            lambda: device_frame_step_packed(x[0], m[0], cfg)))
    return {**out, "p50_ms": p50, "ms_per_frame_b8": best, "peak": peak}


def check_run_frame(stream) -> None:
    """run_frame on frame 0 gives the FrameOutputs of device_frame_step +
    host_outputs."""
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step, host_outputs, run_frame)
    cfg, n = stream.config, int(stream.counts[0])
    got = run_frame(stream.xyz[0], stream.mask[0], cfg)
    want = host_outputs(device_frame_step(stream.xyz[0], stream.mask[0],
                                          cfg), cfg, n)
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        same = (all(np.array_equal(a, b) for a, b in zip(g, w))
                and len(g) == len(w)) if isinstance(g, list) else (
            np.array_equal(g, w) if isinstance(g, np.ndarray) else g == w)
        if not same:
            raise AssertionError(f"run_frame.{field} differs from "
                                 f"device_frame_step + host_outputs")
    log(f"run_frame frame 0 ({cfg.pipeline.clustering_backend}) == "
        f"device_frame_step + host_outputs ({got.num_clusters} clusters, "
        f"{len(got.outlines)} outlines)")


def check_neighbors(stream, smi) -> None:
    """NeighborIndex over frame 0's points, NB_QUERIES queries taken from
    the frame: k_nearest (k = 16) and radius_search (distance_squared,
    capacity 256) on the card equal the CPU run bit for bit; timed."""
    import torch
    from lidar_processing_tpu_torch.ops.neighbors import NeighborIndex
    n = int(stream.counts[0])
    pts = stream.xyz[0, :n]
    queries = pts[::max(1, n // NB_QUERIES)][:NB_QUERIES].contiguous()
    r2 = stream.config.clustering.distance_squared
    gpu, cpu = NeighborIndex(pts), NeighborIndex(pts.cpu())
    calls = {"k_nearest k=16": lambda idx, q: idx.k_nearest(q, 16),
             f"radius_search r2={r2} capacity 256":
             lambda idx, q: idx.radius_search(q, r2, capacity=256)}
    times, extra = [], ""
    for name, call in calls.items():
        got = call(gpu, queries)
        t0 = time.perf_counter()
        want = call(cpu, queries.cpu())
        cpu_s = time.perf_counter() - t0
        for field, a, b in zip(got._fields, got, want):
            if not same_bits(a.cpu(), b):
                raise AssertionError(f"NeighborIndex {name}.{field}: CUDA "
                                     f"and CPU differ")
        times.append(f"{name} {cuda_ms(lambda: call(gpu, queries), reps=3):.3f}"
                     f" ms (CPU {cpu_s:.1f} s)")
        if "radius" in name:
            extra = (f"; {int(got.counts.sum())} neighbours in radius, "
                     f"overflow {int(got.overflow)}")
    log(f"NeighborIndex frame 0 ({n} points, {queries.shape[0]} queries; "
        f"{smi}): CUDA == CPU bit for bit; " + ", ".join(times) + extra)


def check_seg_scans(device) -> None:
    """seg_scan_min / seg_scan_max on the card equal the CPU run bit for
    bit: 131072 rows of (3,) floats over sorted runs, both directions."""
    import torch
    from lidar_processing_tpu_torch.ops.scan_utils import (seg_scan_max,
                                                           seg_scan_min)
    rng = np.random.default_rng(3)
    ids = np.sort(rng.integers(0, 20000, 131072)).astype(np.int32)
    vals = rng.standard_normal((131072, 3)).astype(np.float32)
    v, i = torch.from_numpy(vals), torch.from_numpy(ids)
    for fn in (seg_scan_min, seg_scan_max):
        for reverse in (False, True):
            if not same_bits(fn(v.to(device), i.to(device),
                                reverse=reverse).cpu(),
                             fn(v, i, reverse=reverse)):
                raise AssertionError(f"{fn.__name__}(reverse={reverse}): "
                                     f"CUDA and CPU differ")
    log("seg_scan_min / seg_scan_max (131072 x 3, forward and reverse): "
        "CUDA == CPU bit for bit")


def run_tools(tmp: Path) -> None:
    """The three tools over the written frames, as a user runs them."""
    from lidar_processing_tpu_torch.tools import (measure_caps,
                                                  profile_stages, tier_hist)
    maxima = measure_caps.main(["--data-dir", str(tmp)])
    if int(maxima["overflow"]) != 0:
        raise AssertionError(f"measure_caps: overflow {maxima['overflow']}")
    if tier_hist.main(["--data-dir", str(tmp),
                       "--step", str(N_FRAMES // 2)])["frames"] != 2:
        raise AssertionError("tier_hist did not sample 2 frames")
    profile_stages.main(["--data-dir", str(tmp), "--frames", str(N_FRAMES),
                         "--substages"])
    log(f"tools: measure_caps ({N_FRAMES} frames), tier_hist (2 frames), "
        f"profile_stages ({N_FRAMES} frames, sub-stages) ran to their end")


def run_cellgraph_phase(tmp: Path, device, stixel_results, smi) -> None:
    """The cellgraph backend and the single-device ops (module docstring,
    phase 9)."""
    cg = run_cellgraph_path(tmp, device, stixel_results)
    check_against_radius_cc(device, "cellgraph")
    check_cellgraph_cuda_vs_cpu(cg)
    check_cellgraph_batched(cg)
    count_host_syncs(cg)
    measure_cellgraph(cg, smi)
    check_run_frame(cg)
    check_neighbors(cg, smi)
    check_seg_scans(device)
    run_tools(tmp)


def nccl_rank():
    """Join one NCCL rank on the card (world size 1) at a free localhost
    port: the card's layout of the parallel path. No gloo fallback."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"process group backend {dist.get_backend()}")


def band_maxima(x, m, obst, r: float) -> str:
    """Each frame's densest x-band, over all points and over obstacles,
    at 4 and 8 bands (parallel/spatial.py::_distribute, uncapped)."""
    from lidar_processing_tpu_torch.parallel.spatial import _distribute
    out = []
    for s in SPATIAL_SHARDS[::-1]:
        for what, mask in (("points", m), ("obstacles", obst)):
            bo = _distribute(x, mask, s, x.shape[1], r)[1]
            top = (bo >= 0).sum(-1).amax(-1).tolist()
            out.append(f"{s} bands, {what}: {min(top)}-{max(top)}")
    return "; ".join(out)


def spatial_config(cfg):
    """DEFAULT_CONFIG with the x-band cut of the spatial step:
    block_points SPATIAL_BLOCK_POINTS (shipped 32768), since the step
    distributes every point, not only obstacles."""
    import dataclasses
    return cfg.replace(spatial=dataclasses.replace(
        cfg.spatial, block_points=SPATIAL_BLOCK_POINTS))


def parallel_graphs() -> dict:
    """The registered graphs of the parallel path, {"<entry point>
    <shards of its mesh>": CompiledStep}."""
    from lidar_processing_tpu_torch.parallel.mesh import program_name
    from lidar_processing_tpu_torch.runtime import compiled
    return {program_name(key): step
            for key, step in compiled.programs().items()}


def graph_line(name: str, step) -> str:
    """A graph's kernel nodes, NCCL nodes, node kinds, pool and capture."""
    kinds = ", ".join(f"{k} {n}" for k, n in sorted(step.node_kinds().items()))
    return (f"{name}: tier_min_d2_kernel {step.kernel_nodes(KERNEL_OF['tier_min_d2'])}"
            f", union_find_kernel {step.kernel_nodes(KERNEL_OF['union_find'])}"
            f", NCCL kernel nodes {step.nccl_nodes()} (nodes: {kinds}), "
            f"{step.replays} replays, pool {step.pool_bytes / 2**20:.0f} "
            f"MiB, capture {step.capture_s:.3f} s")


# the parallel path's graphs as drive_spatial builds them: {name: replays}
SPATIAL_GRAPHS = {"cluster_spatial 8": N_FRAMES, "cluster_spatial 4": N_FRAMES,
                  "gpf_spatial 8": N_FRAMES,
                  "device_frame_step_spatial 8": N_FRAMES,
                  "cluster_spatial_2d 2x4": 1, "sharded_batch_step 8": 1,
                  "sharded_pipeline_2d 2x4": 1}


def drive_spatial(stream, obst):
    """The parallel path, driven as a user calls it on one NCCL rank, each
    call on a mesh built anew (equal meshes share a graph), with the
    kernel counts set to 0 just before and read just after:
    cluster_spatial at 8 and 4 shards on each frame's obstacle mask,
    gpf_spatial and device_frame_step_spatial at 8 shards on each frame,
    cluster_spatial_2d and sharded_pipeline_2d on a 2 x 4 mesh (frames
    0-1), sharded_batch_step at B = 8. Every entry point replays its
    registered graph; each graph that clusters holds {tier_min_d2: 2,
    union_find: 1} kernel nodes, gpf_spatial's none; the wrappers count
    only the warm-up steps' and the captures' launches, and the path's
    launches are each graph's nodes x its replays. Returns (results,
    launches)."""
    import torch
    from lidar_processing_tpu_torch.kernels.tier_min_d2 import tier_min_d2
    from lidar_processing_tpu_torch.kernels.union_find import cc_labels
    from lidar_processing_tpu_torch.parallel.frame_spatial import (
        device_frame_step_spatial, gpf_spatial)
    from lidar_processing_tpu_torch.parallel.sharded import (
        make_mesh, make_mesh_2d, sharded_batch_step, sharded_pipeline_2d)
    from lidar_processing_tpu_torch.parallel.spatial import (
        cluster_spatial, cluster_spatial_2d)
    from lidar_processing_tpu_torch.runtime.compiled import WARMUP_STEPS
    cfg = stream.config
    x, m = stream.xyz[:N_FRAMES], stream.mask[:N_FRAMES]
    scfg = spatial_config(cfg)
    r = math.sqrt(cfg.clustering.distance_squared)
    cl = (cfg.clustering, cfg.pipeline, cfg.spatial)
    res = {"spatial": {}}
    tier_min_d2.launches = cc_labels.launches = 0
    for s in SPATIAL_SHARDS:
        for f in range(N_FRAMES):
            res["spatial"][s, f] = cluster_spatial(make_mesh(s, "space"),
                                                   x[f], obst[f], *cl)
    res["gpf"] = [gpf_spatial(make_mesh(8, "space"), x[f], m[f],
                              scfg.segmentation, scfg.spatial, r)
                  for f in range(N_FRAMES)]
    res["step"] = [device_frame_step_spatial(make_mesh(8, "space"), x[f],
                                             m[f], scfg)
                   for f in range(N_FRAMES)]
    res["cl2d"] = cluster_spatial_2d(make_mesh_2d(2, 4), x[:2], obst[:2], *cl)
    res["batch"] = sharded_batch_step(make_mesh(N_FRAMES, "data"), x, m, cfg)
    res["2d"] = sharded_pipeline_2d(make_mesh_2d(2, 4), x[:2], m[:2], cfg)
    torch.cuda.synchronize()
    wrapped = {"tier_min_d2": tier_min_d2.launches,
               "union_find": cc_labels.launches}
    graphs = parallel_graphs()
    if {k: g.replays for k, g in graphs.items()} != SPATIAL_GRAPHS:
        raise AssertionError(f"parallel graphs and replays "
                             f"{ {k: g.replays for k, g in graphs.items()} }"
                             f", not {SPATIAL_GRAPHS}")
    for name, g in graphs.items():
        clusters = not name.startswith("gpf_spatial")
        check_kernel_nodes(g, {"tier_min_d2": 2 * clusters,
                               "union_find": int(clusters), "min_d2": 0,
                               "stamp": 0},
                           f"the {name} graph")
    launches = {k: sum(g.kernel_nodes(KERNEL_OF[k]) * g.replays
                       for g in graphs.values()) for k in wrapped}
    # from Python: each graph's warm-up steps and capture, no replay
    want = {k: (WARMUP_STEPS + 1) * sum(g.kernel_nodes(KERNEL_OF[k])
                                        for g in graphs.values())
            for k in wrapped}
    if wrapped != want:
        raise AssertionError(f"the wrappers launched {wrapped} from Python "
                             f"on the parallel path, expected {want}")
    log(f"parallel path on graphs (one NCCL rank; counts set to 0 before, "
        f"read after): wrappers' launches from Python {wrapped} (the "
        f"warm-up steps and captures), graphs' kernel nodes x replays = "
        f"launches {launches}; each graph:\n  "
        + "\n  ".join(graph_line(k, g) for k, g in graphs.items()))
    return res, launches


def same_tree(a, b) -> bool:
    """Two result trees equal leaf for leaf, bit for bit."""
    import torch
    la, lb = (torch.utils._pytree.tree_leaves(t) for t in (a, b))
    return len(la) == len(lb) and all(same_bits(p, q) for p, q in zip(la, lb))


def check_spatial(stream, res, obst, singles, batch8) -> None:
    """The driven results against their eager bodies and the
    single-device path (module docstring, phase 10)."""
    from lidar_processing_tpu_torch.ops import stixel as sx
    from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
    from lidar_processing_tpu_torch.parallel import frame_spatial as fs
    from lidar_processing_tpu_torch.parallel import sharded as sh
    from lidar_processing_tpu_torch.parallel import spatial as sp
    from lidar_processing_tpu_torch.runtime.pipeline import device_frame_step
    from lidar_processing_tpu_torch.types import SEG_OBSTACLE, map_leaves
    cfg = stream.config
    x, m = stream.xyz[:N_FRAMES], stream.mask[:N_FRAMES]
    scfg = spatial_config(cfg)
    r = math.sqrt(cfg.clustering.distance_squared)
    cl = (cfg.clustering, cfg.pipeline, cfg.spatial)
    mesh8, mesh2d = sh.make_mesh(8, "space"), sh.make_mesh_2d(2, 4)

    def first(tree):
        return map_leaves(lambda t: t[0], tree)
    for (s, f), got in res["spatial"].items():
        eager = first(sp._cluster_bands(sh.make_mesh(s, "space"), "space",
                                        x[f][None], obst[f][None], *cl))
        if not same_tree(got, eager) or not same_tree(got, singles[f]):
            raise AssertionError(f"cluster_spatial {s} shards frame {f}: "
                                 f"the graph differs from its eager body or "
                                 f"from stixel.cluster")
        if int(got.overflow) != 0:
            raise AssertionError(f"cluster_spatial {s} shards frame {f}: "
                                 f"overflow {int(got.overflow)}")
    seg_diff = []
    for f, (fr, (seg, seg_ovf)) in enumerate(zip(res["step"], res["gpf"])):
        n = int(stream.counts[f])
        if not same_tree((seg, seg_ovf), fs._gpf_bands(
                mesh8, x[f], m[f], scfg.segmentation, scfg.spatial, r,
                "space")) or int(seg_ovf) != 0:
            raise AssertionError(f"gpf_spatial frame {f}: the graph differs "
                                 f"from its eager body or overflows")
        if not same_tree(fr, fs._step_spatial(mesh8, x[f], m[f], scfg,
                                              "space")):
            raise AssertionError(f"device_frame_step_spatial frame {f}: the "
                                 f"graph differs from its eager body")
        if not same_bits(fr.seg.labels, seg.labels):
            raise AssertionError(f"device_frame_step_spatial frame {f}: seg "
                                 f"differs from gpf_spatial's")
        one = device_frame_step(x[f], m[f], cfg)
        seg_diff.append(int((fr.seg.labels[:n] != one.seg.labels[:n]).sum()))
        if seg_diff[-1] > max(2, n // 1000):
            raise AssertionError(f"device_frame_step_spatial frame {f}: "
                                 f"{seg_diff[-1]} of {n} seg labels differ")
        own = m[f] & (fr.seg.labels == SEG_OBSTACLE)
        ref = sx.cluster(x[f], own, cfg.clustering, cfg.pipeline)
        if not same_tree(fr.clustering, ref):
            raise AssertionError(f"device_frame_step_spatial frame {f}: "
                                 f"clustering differs from stixel.cluster "
                                 f"of its own obstacle mask")
        if (int(fr.clustering.overflow), int(fr.hull_overflow)) != (0, 0) \
                or int(fr.n_small) + int(fr.n_large) \
                != int(fr.clustering.num_clusters):
            raise AssertionError(
                f"device_frame_step_spatial frame {f}: overflow "
                f"{int(fr.clustering.overflow)}, hull_overflow "
                f"{int(fr.hull_overflow)}, {int(fr.n_small)} + "
                f"{int(fr.n_large)} slots for "
                f"{int(fr.clustering.num_clusters)} clusters")
    cl2d = sp._spatial_2d_program(mesh2d, ("data", "space"), x[:2], obst[:2],
                                  cl)
    if not same_tree(res["cl2d"], cl2d) or not same_tree(
            res["cl2d"], sx.cluster(x[:2], obst[:2], *cl[:2])):
        raise AssertionError("cluster_spatial_2d: the graph differs from its "
                             "eager body or from stixel.cluster")
    if not same_tree(res["batch"], sh._batch_step(
            sh.make_mesh(N_FRAMES, "data"), x, m, cfg)) \
            or not same_tree(res["batch"], batch8):
        raise AssertionError("sharded_batch_step B=8: the graph differs from "
                             "its eager body or from "
                             "device_frame_step_batched")
    seg2, cl2 = res["2d"]
    if not same_tree(res["2d"], sh._pipeline_2d(mesh2d, x[:2], m[:2], cfg)):
        raise AssertionError("sharded_pipeline_2d: the graph differs from "
                             "its eager body")
    if not same_tree(seg2, gpf_segment(x[:2], m[:2], cfg.segmentation)):
        raise AssertionError("sharded_pipeline_2d: segmentation differs "
                             "from gpf_segment")
    ref2 = sx.cluster(x[:2], m[:2] & (seg2.labels == SEG_OBSTACLE),
                      cfg.clustering, cfg.pipeline)
    if not same_tree(cl2, ref2) or int(cl2.overflow.sum()) != 0:
        raise AssertionError("sharded_pipeline_2d: clustering differs from "
                             "stixel.cluster or overflows")
    log(f"parallel path (one NCCL rank), every graph's result == its eager "
        f"body's bit for bit: cluster_spatial at "
        f"{'/'.join(map(str, SPATIAL_SHARDS))} shards == stixel.cluster bit "
        f"for bit on frames 0-{N_FRAMES - 1}, overflow 0; gpf_spatial and "
        f"device_frame_step_spatial (8 shards, block_points "
        f"{SPATIAL_BLOCK_POINTS}): seg labels differing from "
        f"device_frame_step {seg_diff}, clustering == stixel.cluster of its "
        f"own obstacle mask, overflow 0, hull_overflow 0, n_small + n_large "
        f"== num_clusters "
        f"{[int(fr.clustering.num_clusters) for fr in res['step']]}; "
        f"cluster_spatial_2d (2 x 4, frames 0-1) == stixel.cluster; "
        f"sharded_batch_step B={N_FRAMES} == device_frame_step_batched leaf "
        f"for leaf; sharded_pipeline_2d (2 x 4, frames 0-1) == gpf_segment "
        f"+ stixel.cluster")


def check_spatial_kernels(stream, obst) -> None:
    """Frame 0's 8-shard cluster_spatial kernel calls (one launch each
    for the 8 bands, recorded from its eager body) against the twins on
    the card, bit for bit."""
    from lidar_processing_tpu_torch.kernels.tier_min_d2 import (
        tier_min_d2, tier_min_d2_ref)
    from lidar_processing_tpu_torch.kernels.union_find import (cc_labels,
                                                               cc_labels_ref)
    from lidar_processing_tpu_torch.ops import stixel as sx
    from lidar_processing_tpu_torch.parallel.sharded import make_mesh
    from lidar_processing_tpu_torch.parallel.spatial import _cluster_bands
    cfg = stream.config
    calls = {"tier_min_d2": [], "union_find": []}
    kernels = (sx.tier_min_d2, sx.cc_labels)

    def recording(name, fn):
        def record(*args):
            calls[name].append(args)
            return fn(*args)
        return record
    sx.tier_min_d2 = recording("tier_min_d2", kernels[0])
    sx.cc_labels = recording("union_find", kernels[1])
    try:
        _cluster_bands(make_mesh(8, "space"), "space", stream.xyz[:1],
                       obst[:1], cfg.clustering, cfg.pipeline, cfg.spatial)
    finally:
        sx.tier_min_d2, sx.cc_labels = kernels
    if (len(calls["tier_min_d2"]), len(calls["union_find"])) != (2, 1):
        raise AssertionError(f"frame 0's cluster_spatial: {calls} calls")
    shapes = []
    for name, fn, twin in (("tier_min_d2", tier_min_d2, tier_min_d2_ref),
                           ("union_find", cc_labels, cc_labels_ref)):
        for args in calls[name]:
            if not same_bits(fn(*args), twin(*args)):
                raise AssertionError(f"{name} on frame 0's 8 bands: kernel "
                                     f"differs from its twin")
            shapes.append(f"{name} {tuple(args[0].shape)}")
    log(f"spatial kernels (frame 0, 8 bands, one launch each): "
        f"{', '.join(shapes)}: kernel == twin bit for bit")


def spatial_host_syncs(stream, obst) -> int:
    """Host syncs inside one cluster_spatial call at 8 shards, its eager
    body and its replay (torch's sync debug mode, as count_host_syncs
    reads the step)."""
    import warnings
    import torch
    from lidar_processing_tpu_torch.parallel.sharded import make_mesh
    from lidar_processing_tpu_torch.parallel.spatial import (_cluster_bands,
                                                             cluster_spatial)
    cfg, mesh = stream.config, make_mesh(8, "space")
    cl = (cfg.clustering, cfg.pipeline, cfg.spatial)
    out = {}
    for route, call in (
            ("eager body", lambda: _cluster_bands(
                mesh, "space", stream.xyz[:1], obst[:1], *cl)),
            ("replay", lambda: cluster_spatial(mesh, stream.xyz[0], obst[0],
                                               *cl))):
        call()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        out[route] = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                      if "called a synchronizing" in str(w.message)]
    log(f"host syncs in one cluster_spatial call (8 shards): "
        + ", ".join(f"{k} {len(v)}" for k, v in out.items())
        + "".join(f"\n  at {s}" for v in out.values() for s in sorted(set(v))))
    if any(out.values()):
        raise AssertionError("cluster_spatial waits on the card")
    return sum(len(v) for v in out.values())


def time_spatial(stream, obst, smi) -> dict:
    """Graph against graph, p50 over the 8 frames of CUDA-event times (3
    repeats a frame): cluster_spatial at 4 and 8 shards against the
    clustering stage's graph (stixel.cluster) on the same masks, and
    device_frame_step_spatial (8 shards) against the main path's graph
    (the B = 1 batched step); each route's eager p50 beside it, with the
    kernels and device ms of one eager call (torch.profiler: no graph
    replay is profiled before the probes) and its peak device memory
    (its own), and each graph's pool."""
    import torch
    from lidar_processing_tpu_torch.ops import stixel as sx
    from lidar_processing_tpu_torch.parallel import frame_spatial as fs
    from lidar_processing_tpu_torch.parallel.sharded import make_mesh
    from lidar_processing_tpu_torch.parallel import spatial as sp
    from lidar_processing_tpu_torch.runtime.compiled import CompiledStep
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step, device_frame_step_batched)
    from lidar_processing_tpu_torch.runtime.stream import cluster_stage
    from lidar_processing_tpu_torch.tools.step_bench import step_kernels
    cfg, dev = stream.config, stream.device
    x, m = stream.xyz, stream.mask
    scfg = spatial_config(cfg)
    cl = (cfg.clustering, cfg.pipeline, cfg.spatial)
    meshes = {s: make_mesh(s, "space") for s in SPATIAL_SHARDS}
    stage = CompiledStep(cluster_stage, cfg, 1, dev)
    main = CompiledStep(device_frame_step_batched, cfg, 1, dev)
    runs = {}
    for s in SPATIAL_SHARDS[::-1]:
        runs[f"cluster_spatial {s}"] = (
            lambda f, s=s: sp.cluster_spatial(meshes[s], x[f], obst[f], *cl),
            lambda f, s=s: sp._cluster_bands(meshes[s], "space",
                                             x[f:f + 1], obst[f:f + 1], *cl),
            None)
    runs["stixel.cluster"] = (lambda f: stage(x[f:f + 1], obst[f:f + 1]),
                              lambda f: sx.cluster(x[f], obst[f], *cl[:2]),
                              stage)
    runs["device_frame_step_spatial 8"] = (
        lambda f: fs.device_frame_step_spatial(meshes[8], x[f], m[f], scfg),
        lambda f: fs._step_spatial(meshes[8], x[f], m[f], scfg, "space"),
        None)
    runs["device_frame_step"] = (lambda f: main(x[f:f + 1], m[f:f + 1]),
                                 lambda f: device_frame_step(x[f], m[f], cfg),
                                 main)
    out = {}
    for name, (graph, eager, step) in runs.items():
        p50 = {route: statistics.median(cuda_ms(lambda f=f: fn(f), reps=3)
                                        for f in range(N_FRAMES))
               for route, fn in (("graph", graph), ("eager", eager))}
        prof = step_kernels(lambda: eager(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        eager(0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
        if step is None:
            step = parallel_graphs()[name]
        out[name] = {"graph_p50_ms": p50["graph"], "eager_p50_ms": p50["eager"],
                     **prof, "peak_mib": peak / 2 ** 20,
                     "pool_mib": step.pool_bytes / 2 ** 20}
    stage.release()
    main.release()
    ratio = {k: out[k]["graph_p50_ms"] / out[ref]["graph_p50_ms"]
             for k, ref in (("cluster_spatial 8", "stixel.cluster"),
                            ("cluster_spatial 4", "stixel.cluster"),
                            ("device_frame_step_spatial 8",
                             "device_frame_step"))}
    log(f"parallel path timings ({smi}; one NCCL rank; CUDA events, p50 "
        f"over {N_FRAMES} frames x 3; kernels and device ms of one eager "
        f"call from torch.profiler, its peak memory its own; the graph's "
        f"pool): "
        + "; ".join(f"{k} graph {v['graph_p50_ms']:.3f} ms, eager "
                    f"{v['eager_p50_ms']:.3f} ms, {v['kernels']} kernels, "
                    f"{v['busy_ms']:.3f} ms device, eager peak "
                    f"{v['peak_mib']:.0f} MiB, pool {v['pool_mib']:.0f} MiB"
                    for k, v in out.items())
        + "; graph against graph: " + ", ".join(
            f"{k} / its single-device graph {v:.2f}x"
            for k, v in ratio.items()))
    return out


def release_all_graphs() -> None:
    """Free every registered graph; no graph is held in the process
    after (the probes' profiles need none)."""
    from lidar_processing_tpu_torch.runtime import compiled
    compiled.release_graphs()
    torch_empty_cache()
    if compiled.live_graphs():
        raise AssertionError(f"{compiled.live_graphs()} CUDA graphs still "
                             f"held")


def run_spatial_phase(stream, smi) -> dict:
    """The sharded and spatial phase (module docstring, phase 10), on one
    NCCL rank; returns the kernel launches of its driven path."""
    import torch.distributed as dist
    from lidar_processing_tpu_torch.ops import stixel as sx
    from lidar_processing_tpu_torch.runtime.pipeline import (
        device_frame_step_batched)
    from lidar_processing_tpu_torch.tools import scaling_bench
    from lidar_processing_tpu_torch.types import SEG_OBSTACLE
    cfg = stream.config
    x, m = stream.xyz[:N_FRAMES], stream.mask[:N_FRAMES]
    nccl_rank()
    try:
        batch8 = device_frame_step_batched(x, m, cfg)
        obst = m & (batch8.seg.labels == SEG_OBSTACLE)
        log("x-band populations, frames 0-7 (densest band): " + band_maxima(
            x, m, obst, math.sqrt(cfg.clustering.distance_squared)))
        singles = [sx.cluster(x[f], obst[f], cfg.clustering, cfg.pipeline)
                   for f in range(N_FRAMES)]
        res, launches = drive_spatial(stream, obst)
        check_spatial(stream, res, obst, singles, batch8)
        check_spatial_kernels(stream, obst)
        spatial_host_syncs(stream, obst)
        time_spatial(stream, obst, smi)
        release_all_graphs()
        out = scaling_bench.main([])
        if set(out["data"]) != {1, 2, 4, 8} or "mesh_2d" not in out:
            raise AssertionError(f"scaling_bench: {out}")
    finally:
        release_all_graphs()
        dist.destroy_process_group()
    return launches


def check_parallel_graph_launches(stream) -> None:
    """torch.profiler on one parallel graph's replay (cluster_spatial at
    8 shards, frame 0, one NCCL rank): one cudaGraphLaunch and no kernel
    launch call, and as many tier_min_d2_kernel and union_find_kernel
    runs as the graph holds nodes of; released after."""
    import torch.distributed as dist
    from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
    from lidar_processing_tpu_torch.parallel.sharded import make_mesh
    from lidar_processing_tpu_torch.parallel.spatial import cluster_spatial
    from lidar_processing_tpu_torch.tools.step_bench import step_kernels
    from lidar_processing_tpu_torch.types import SEG_OBSTACLE
    cfg = stream.config
    x, m = stream.xyz[0], stream.mask[0]
    obst = m & (gpf_segment(x, m, cfg.segmentation).labels == SEG_OBSTACLE)
    nccl_rank()
    try:
        def call():
            return cluster_spatial(make_mesh(8, "space"), x, obst,
                                   cfg.clustering, cfg.pipeline, cfg.spatial)
        call()
        (step,) = parallel_graphs().values()
        graph = step_kernels(call)
        if (graph["graph_launches"], graph["launch_calls"]) != (1, 0):
            raise AssertionError(f"a cluster_spatial replay: {graph}")
        _, ran = kernel_counts(call)
        inside = {k: launches_of(ran, k) for k in ("tier_min_d2_kernel",
                                                   "union_find_kernel")}
        nodes = {k: step.kernel_nodes(k) for k in inside}
        nccl = sum(n for k, n in ran.items() if "nccl" in k.lower())
        if inside != nodes or nodes != {"tier_min_d2_kernel": 2,
                                        "union_find_kernel": 1}:
            raise AssertionError(f"a cluster_spatial replay ran {inside}; "
                                 f"its graph holds {nodes}")
        log(f"cluster_spatial 8's graph (torch.profiler, frame 0, one NCCL "
            f"rank): {graph['graph_launches']} cudaGraphLaunch and "
            f"{graph['launch_calls']} kernel launch calls a call, "
            f"{graph['kernels']} CUDA kernels and {graph['copies']} copies "
            f"and fills inside, {graph['busy_ms']:.3f} ms of device time, "
            f"{inside} of them the hand kernels (== the graph's nodes), "
            f"{nccl} NCCL kernels (the graph's NCCL kernel nodes: "
            f"{step.nccl_nodes()})")
    finally:
        release_all_graphs()
        dist.destroy_process_group()


def main() -> None:
    device, smi = check_device()
    with phase("build"):
        build_s, native_s = build_all()
    # the main path first: its step is bound by the host's launch path, so
    # it is timed before the profiler and the large yardstick calls of the
    # kernel checks can slow the process down
    with tempfile.TemporaryDirectory() as tmp:
        with phase("frames"):
            write_frames(Path(tmp))
        with phase("main path"):
            stream, results, launches, e2e_ms, route = run_main_path(
                Path(tmp), device)
        with phase("CUDA vs CPU"):
            check_cuda_vs_cpu(stream)
            check_against_radius_cc(device)
            count_host_syncs(stream)
        with phase("timings"):
            dev_ms, host_ms = time_frames(stream, results, device)
        log(f"per frame ({smi}): device p50 (compiled step) {dev_ms:.3f} "
            f"ms, host p50 {host_ms:.1f} ms, end to end {e2e_ms:.1f} ms "
            f"(build {build_s:.1f} s)")
        with phase("batched step"):
            batched_calls = run_batched_path(stream)
        with phase("host stage and entry points"):
            check_host_stage(Path(tmp), stream, route, native_s, smi)
        with phase("compiled step"):
            check_graph_steps(stream)
            stream.release()          # captured again in phase 15b
            torch_empty_cache()
        with phase("cellgraph and single-device ops"):
            run_cellgraph_phase(Path(tmp), device, results, smi)
        with phase("sharded and spatial"):
            spatial_launches = run_spatial_phase(stream, smi)
    with phase("knife edge"):
        check_knife(device)
    with phase("step kernels"):
        log_step_kernels(stream)
    with phase("kernels vs twins"):
        res, dbg, tier_calls = frame0_debug(device)
        edges = (dbg["e_u"], dbg["e_v"], dbg["n_edges"])
        uf_record, hybrid_launches = check_union_find(device, edges)
        kernels = [check_tier_min_d2(device, tier_calls), uf_record,
                   check_min_d2(device)]
        check_batched_kernels(batched_calls)
    with phase("probes"):
        kernels += check_uf_probes(device, edges, smi)
        kernels += check_pairs(device) + check_mosaic2(device)
        frame_edges, frame_pairs = check_real_frame(device, res, dbg)
        parent_turns(frame_pairs, smi)
        probe_launches = run_probe_path(device, frame_edges)
    with phase("compiled step: profiles and turns"):
        check_parallel_graph_launches(stream)
        run_graph_turns(stream, smi)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    import torch
    # rows 1-2: the main path's launches (its graph's kernel nodes x its
    # replays) and the parallel path's; union_find's also the hybrid path's
    counts = {**launches, **probe_launches,
              "tier_min_d2": launches["tier_min_d2"]
              + spatial_launches["tier_min_d2"],
              "union_find": launches["union_find"] + hybrid_launches
              + spatial_launches["union_find"]}
    record = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": counts[k["name"]],
         **{f: k[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}}
        for k in kernels]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
