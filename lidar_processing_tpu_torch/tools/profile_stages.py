"""Per-stage times of the device step, by CUDA events.

    python -m lidar_processing_tpu_torch.tools.profile_stages \\
        [--frames N] [--substages] [--data-dir DIR] [--device cuda]

The counterpart of the repo's ``tools/profile_stages.py`` (the reference's
per-stage chrono logs at device granularity, ref: src/processor.cpp:
167-168,204-205,218-219). The first ``--frames`` frames of ``--data-dir``
(default: the checkout's ``data/``) at DEFAULT_CONFIG; each line is one
warmup pass over the frames, then one timed pass, in ms per frame:

  full device_frame_step      the whole B = 1 step
  1. gpf_segment_sorted       segmentation, as the step runs it
  2. cluster_fused            clustering, on stage 1's outputs
  3. label runs + hull stage  on stage 2's outputs
  4. pack_host_payload        on stage 3's FrameResult

Each stage runs on the previous stage's recorded outputs, so the four add
up to the step less nothing but Python glue. With ``--substages``, the
stixel sub-stages and the hull stage's parts: every call the step makes
to ``_sort_points_full``, ``_build_cells``, ``_tiered_exact`` (intra,
then supernode pairs), ``_build_supernodes``, ``_column_pairs``,
``cc_labels``, ``label_runs_presorted``, ``gather_runs`` and
``convex_hulls_batched`` is recorded with its arguments and timed alone
on them, and "2. rest" is the clustering stage less its timed parts.
Eager PyTorch launches every op from the host, so on a launch-bound step
these are the host's launch times as much as the card's. Runs on the card
unless ``--device`` names another (the host clock then; it raises
without a card).
"""

from __future__ import annotations

import argparse

import torch

from ..config import DEFAULT_CONFIG
from ._common import clock, resolve_device, time_ms

_STIXEL_PARTS = ("_sort_points_full", "_build_cells", "_tiered_exact",
                 "_build_supernodes", "_column_pairs", "cc_labels")
_HULL_PARTS = ("label_runs_presorted", "gather_runs", "convex_hulls_batched")


def _timed(fn, args_list, name: str, dev) -> float:
    """ms per frame of fn over every frame's args (one warmup pass)."""
    ms = time_ms(lambda: [fn(*a) for a in args_list], dev, reps=1)
    ms /= len(args_list)
    print(f"{name:32s} {ms:8.3f} ms/frame", flush=True)
    return ms


def record_calls(module, names, run):
    """Run `run()` with module.<name> wrapped for each name; returns
    {name: [args of each call, in call order]}."""
    calls = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def recorder(name):
        def rec(*args, **kwargs):
            calls[name].append((args, kwargs))
            return saved[name](*args, **kwargs)
        return rec

    for name in names:
        setattr(module, name, recorder(name))
    try:
        run()
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    return calls


def _substages(module, names, run_frames, dev, stage_ms=None) -> dict:
    """Time each recorded call of module.<names> over the frames."""
    per_frame = [record_calls(module, names, run) for run in run_frames]
    out = {}
    for name in names:
        for i in range(len(per_frame[0][name])):
            fn = getattr(module, name)
            label = name if len(per_frame[0][name]) == 1 else f"{name}#{i + 1}"
            calls = [c[name][i] for c in per_frame]
            out[label] = _timed(lambda a, k: fn(*a, **k), calls,
                                f"  {label}", dev)
    if stage_ms is not None:
        print(f"{'  rest (glue between them)':32s} "
              f"{stage_ms - sum(out.values()):8.3f} ms/frame", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--substages", action="store_true")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..io.dataset import list_frames, load_frame
    from ..io.synthetic import pad_frame
    from ..ops import stixel as sx
    from ..ops.segmentation import gpf_segment_sorted
    from ..runtime import pipeline as pl
    from ..types import SEG_OBSTACLE, SegmentationResult

    cfg = DEFAULT_CONFIG
    dev = resolve_device(args.device)
    paths = list_frames(args.data_dir) if args.data_dir else list_frames()
    clouds = []
    for path in paths[:args.frames]:
        x, m = pad_frame(load_frame(path)[0], cfg.pipeline.max_points)
        clouds.append((torch.from_numpy(x).to(dev)[None],
                       torch.from_numpy(m).to(dev)[None]))
    print(f"device={dev} ({clock(dev)}) frames={len(clouds)}", flush=True)

    def fused(ss):
        return sx.cluster_fused(ss.xyz, ss.valid & (ss.labels == SEG_OBSTACLE),
                                ss.valid, ss.orig, ss.labels, cfg.clustering,
                                cfg.pipeline)

    def hull(ss, fu, n):
        seg = SegmentationResult(fu.seg_labels, ss.planes, ss.plane_valid)
        runs = pl.label_runs_presorted(fu.sorted_xyz, fu.sorted_label,
                                       fu.sorted_orig, pl.NUM_SLOTS,
                                       orig_bound=n)
        return pl._hull_stage(seg, fu.result, runs, cfg)

    out = {"full": _timed(lambda x, m: pl.device_frame_step_batched(
        x, m, cfg), clouds, "full device_frame_step", dev)}
    out["1"] = _timed(lambda x, m: gpf_segment_sorted(x, m, cfg.segmentation),
                      clouds, "1. gpf_segment_sorted", dev)
    segs = [gpf_segment_sorted(x, m, cfg.segmentation) for x, m in clouds]
    out["2"] = _timed(fused, [(ss,) for ss in segs], "2. cluster_fused", dev)
    fus = [fused(ss) for ss in segs]
    n = cfg.pipeline.max_points
    out["3"] = _timed(hull, [(ss, fu, n) for ss, fu in zip(segs, fus)],
                      "3. label runs + hull stage", dev)
    frs = [hull(ss, fu, n) for ss, fu in zip(segs, fus)]
    out["4"] = _timed(lambda fr: pl.pack_host_payload(fr, cfg),
                      [(fr,) for fr in frs], "4. pack_host_payload", dev)
    print(f"{'sum of stages 1-4':32s} "
          f"{out['1'] + out['2'] + out['3'] + out['4']:8.3f} ms/frame")

    if args.substages:
        out["2_parts"] = _substages(
            sx, _STIXEL_PARTS, [lambda ss=ss: fused(ss) for ss in segs], dev,
            stage_ms=out["2"])
        out["3_parts"] = _substages(
            pl, _HULL_PARTS,
            [lambda ss=ss, fu=fu: hull(ss, fu, n)
             for ss, fu in zip(segs, fus)], dev, stage_ms=out["3"])
    print("done")
    return out


if __name__ == "__main__":
    main()
