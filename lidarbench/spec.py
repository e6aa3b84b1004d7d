"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root lists cells and metrics; each
configuration is ``lidarbench/configs/<name>.json``, each traffic mix
``lidarbench/traffic/<name>.json``, each configuration's correctness
limits ``lidarbench/limits/<name>.json`` and each per-layer metric a
reader ``lidarbench/metrics/<name>.py`` with ``read(ctx)``. A new cell,
mix, configuration or metric is new files plus new entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Spec:
    """BENCHMARK.json and the files it names, under one root."""

    def __init__(self, root: str = ROOT, bench_dir: str = HERE):
        self.root, self.dir = root, bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def _json(self, kind: str, name: str) -> Dict:
        with open(os.path.join(self.dir, kind, f"{name}.json")) as f:
            return json.load(f)

    def workload(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, name: str) -> Dict[str, float]:
        return self._json("limits", name)

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        mod_spec = importlib.util.spec_from_file_location(
            "lidarbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read

    def end_to_end(self, workload: str) -> List[Dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics the cell reports: those that list it, and
        those with no list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]
