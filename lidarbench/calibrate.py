"""Readings that the correctness limits are set from, on the card.

    python3 -m lidarbench.calibrate --workload <cell> --seeds S1 S2 ...
        [--control-seeds C1 C2 C3] [--convex-seeds F1 F2 F3]
        [--streets K] [--seconds 4] [--out FILE]

For each seed, one run of the cell as ``lidarbench.run`` makes it (set-up,
a short window at the cell's own load, the check), in this one process,
printing the check's numbers: the program's readings. For each control
seed, the control (``check.control``: the reference computed on
bfloat16 coordinates, in the program's place) judged on the same
resident frames: the control's readings. For each convex seed, a run
of the program with its own convex-outline path switched on
(``polygonizer_concave`` false), the fault of outlines that lose their
cluster's concavities. ``--streets K`` makes the resident sweeps from
scene seeds K, K+1, ... instead of 0, 1, ..., so that the readings
cover other streets than the cells' own. One JSON line each, to
standard output and to ``--out``.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lidarbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--convex-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--streets", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from . import check, harness, scenes
    from .spec import Spec
    if not torch.cuda.is_available():
        print("lidarbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec()
    cell = spec.workload(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    if args.streets:
        def make_frames(config, seed, count):
            rng = np.random.default_rng(np.random.SeedSequence(abs(seed)))
            return [scenes.street_sweep(args.streets + int(k), config)
                    for k in rng.permutation(count)]
        harness.make_frames = make_frames
    config = spec.config(cell["config"])
    convex = dict(config, engine=dict(config["engine"], polygonization=dict(
        config["engine"].get("polygonization", {}),
        polygonizer_concave=False)))
    for who, seeds, cfg in (("program", args.seeds, config),
                            ("convex", args.convex_seeds, convex)):
        for seed in seeds:
            t = time.perf_counter()
            res = harness.run_cell(spec, args.workload, seed, args.seconds,
                                   False, t, config=cfg)
            emit({"workload": args.workload, "who": who, "seed": seed,
                  "streets": args.streets, "correct": res.line["correct"],
                  "numbers": {k: v["value"]
                              for k, v in res.line["checks"].items()},
                  "metrics": {k: v["value"]
                              for k, v in res.line["metrics"].items()},
                  "seconds": time.perf_counter() - t})
    traffic = spec.traffic(cell["traffic"])
    engine = dataclasses.asdict(harness.engine_config(config, traffic))
    limits = spec.limits(cell["config"])
    for seed in args.control_seeds:
        t = time.perf_counter()
        frames = [f[0] for f in harness.make_frames(
            config, seed, traffic["resident_frames"])]
        deliveries = [(i, check.control(xyz, engine, "cuda"))
                      for i, xyz in enumerate(frames)]
        v = check.judge(frames, deliveries, engine, limits, "cuda")
        emit({"workload": args.workload, "who": "control", "seed": seed,
              "streets": args.streets, "correct": v.correct,
              "numbers": v.numbers,
              "seconds": time.perf_counter() - t})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
