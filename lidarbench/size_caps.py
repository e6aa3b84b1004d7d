"""Size a configuration's capacities from its own sweeps.

    python -m lidarbench.size_caps --config lidarbench/configs/<name>.json \\
        [--streets 112] [--widen 2] [--device cuda]

The configuration's sensor sees streets 0 to ``--streets`` - 1
(``scenes.street_sweep``); each sweep runs through the port's
``tools/measure_caps.py::frame_stats`` on the engine the benchmark builds
from the file (``harness.engine_config``), with every capacity ``--widen``
times the configuration's (``measure_caps.widened``), so that no quantity
is clipped by the cap it sizes. Prints the maxima, then each cap's row:
the maximum, the configuration's value and 1.2 times the maximum rounded
up to a multiple of 32 (``measure_caps.cap_table``). Returns the maxima.
Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True,
                    help="a benchmark configuration file")
    ap.add_argument("--streets", type=int, default=112)
    ap.add_argument("--widen", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from lidar_processing_tpu_torch.tools import measure_caps
    from lidar_processing_tpu_torch.tools._common import resolve_device

    from lidarbench import scenes
    from lidarbench.harness import engine_config

    with open(args.config) as f:
        config = json.load(f)
    engine = engine_config(config, {"loop": "closed", "queue_depth": 2})
    dev = resolve_device(args.device)
    frames = ((f"street {k}", scenes.street_sweep(k, config)[0])
              for k in range(args.streets))
    maxima = measure_caps.measure(frames, measure_caps.widened(
        engine, args.widen), dev)
    print(f"\n=== maxima over {args.streets} streets ({dev.type}) ===")
    for k, v in maxima.items():
        print(f"{k:12s} {v}")
    print(f"\n=== caps of {config['name']} (measured at {args.widen}x its "
          f"capacities) ===\n{'quantity':14s} {'max':>8s} {'cap':>8s} "
          f"{'1.2x/32':>8s}")
    for name, v, cap, sized in measure_caps.cap_table(maxima, engine):
        print(f"{name:14s} {v:8d} {cap:8d} {sized:8d}")
    return maxima


if __name__ == "__main__":
    main()
