"""Throughput of the batched step (B frames per device step) on one GPU.

The port of the repo's root ``tools/bench_batch.py`` (the JAX package's,
which jits a vmap of its step). The per-frame step is dominated by the
host's launch path of thousands of small kernels (PERF.md §5); a batch of
B frames launches each op, and both hand-written kernels, once for all B,
which spreads that fixed cost over them. This measures ms/frame at
several batch sizes over the resident frames of ``--data-dir``:

    python -m lidar_processing_tpu_torch.tools.bench_batch \\
        [--batches 4 8] [--frames N] [--data-dir DIR] [--device cuda] \\
        [--eager]

For each B: the step over the first frames (rounded down to a multiple of
B; one batch of the frames repeated cyclically when B exceeds them), one
warmup call, then one timed pass waited for at its end, printed as
``B=  8:    x.xxx ms/frame (  yy.y fps)``. On the card the step is the
compiled step (runtime/compiled.py: ``device_frame_step_batched``
captured once per B as a CUDA graph and replayed, as the JAX tool jits
its vmap); ``--eager`` times the eager step, which the CPU always runs.
The first line names the backend, the route (``step=graph|eager``) and
the frames. Runs on the card unless ``--device`` names another (it
raises without one).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..config import DEFAULT_CONFIG


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[8])
    ap.add_argument("--frames", type=int, default=None,
                    help="frames to use (default: all of --data-dir)")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="time the eager step instead of the compiled step")
    args = ap.parse_args(argv)

    from ..runtime.compiled import batched_step, uses_graph
    from ..runtime.pipeline import device_frame_step_batched
    from ..runtime.stream import ReplayStream

    cfg = DEFAULT_CONFIG
    stream = ReplayStream(cfg, data_dir=args.data_dir, device=args.device)
    n_frames = min(args.frames or stream.num_frames, stream.num_frames)
    route = "graph" if uses_graph(stream.device, args.eager) else "eager"
    print(f"backend={stream.device.type} step={route} frames={n_frames}",
          flush=True)
    out = {}
    for b in args.batches:
        n = max(b, n_frames // b * b)
        ids = torch.arange(n, device=stream.device) % n_frames
        batches = [(stream.xyz[ids[i:i + b]], stream.mask[ids[i:i + b]])
                   for i in range(0, n, b)]
        step = batched_step(device_frame_step_batched, cfg, b,
                            stream.device, args.eager)
        step(*batches[0])
        stream.sync()
        t0 = time.perf_counter()
        for x, m in batches:
            step(x, m)
        stream.sync()
        dt = time.perf_counter() - t0
        out[b] = dt / n * 1e3
        print(f"B={b:3d}: {out[b]:8.3f} ms/frame ({n / dt:6.1f} fps)",
              flush=True)
    return out


if __name__ == "__main__":
    main()
