"""The harness on the CPU: its files found by name, the traffic loops and
the metric arithmetic against stubs, BENCHMARK.json against the
contract, and the command's refusal without a card."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from lidarbench import drive, harness
from lidarbench.spec import ROOT, Spec
from lidarbench.trace import Trace, parse

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_named_file_loads(spec):
    b = spec.bench
    for c in b["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(spec.limits(c["name"])) >= set(
            __import__("lidarbench.check").check.NUMBERS)
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        tr = spec.traffic(w["traffic"])
        assert tr["loop"] in ("open", "closed")
        harness.engine_config(spec.config(w["config"]), tr)
        names = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer(w["name"])
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_new_traffic_file_is_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "lidarbench"), root / "lidarbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    (root / "lidarbench" / "traffic" / "dummy-burst.json").write_text(
        json.dumps({"loop": "open", "rate_hz": 10.0, "queue_depth": 2,
                    "resident_frames": 4,
                    "trace": {"skip_frames": 1, "frames": 2}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "kitti-hdl64e.dummy-burst",
                               "config": "kitti-hdl64e-host-outlines",
                               "traffic": "dummy-burst", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(str(root), str(root / "lidarbench"))
    w = spec.workload("kitti-hdl64e.dummy-burst")
    assert spec.traffic(w["traffic"])["resident_frames"] == 4
    cfg = harness.engine_config(spec.config(w["config"]),
                                spec.traffic(w["traffic"]))
    assert cfg.pipeline.queue_depth == 2


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Stub:
    """A stream that delivers frame k of its schedule at a set time."""

    def __init__(self, clock, num_frames, deliver):
        self.clock, self.num_frames, self.deliver = clock, num_frames, deliver

    def run(self, n, realtime=False, with_outlines=True):
        assert with_outlines
        seq = 0
        for k, (t, dropped) in enumerate(self.deliver):
            seq += dropped
            self.clock.t = t
            yield (f"out{seq}", SimpleNamespace(
                frame_id=seq % self.num_frames, frames_dropped=dropped,
                t_dispatch_ms=2.0 * (k + 1), t_host_ms=1.0))
            seq += 1


def test_open_loop_latency_counts_drops_in_the_tail():
    clock = _Clock()
    # 10 Hz, 1 s window: frames 0..9 due; frame 4 dropped; each delivered
    # 0.2 s + 10 ms after its publication
    times = []
    for s in range(12):
        if s == 4:
            continue
        times.append((s * 0.1 + 0.21, 1 if s == 5 else 0))
    w = drive.open_loop(_Stub(clock, 3, times), 10.0, 1.0, clock=clock)
    assert w.attempted == 10 and w.failed == 1
    assert [d.seq for d in w.deliveries] == [0, 1, 2, 3, 5, 6, 7, 8, 9]
    assert w.metrics["latency_p50_ms"] == pytest.approx(210.0)
    # the dropped frame is the tail: pending from 0.4 s to the end (1.11 s)
    assert w.metrics["latency_p95_ms"] == pytest.approx(710.0)


def test_closed_loop_rate():
    clock = _Clock()
    times = [(0.5 + 0.02 * k, 0) for k in range(200)]
    w = drive.closed_loop(_Stub(clock, 16, times), 1.0, clock=clock)
    assert w.metrics["frames_per_s"] == pytest.approx(50.0)
    assert w.deliveries[-1].t - w.deliveries[0].t >= 1.0


def test_the_check_sample_is_drawn_from_the_seed():
    a = harness.check_sample(2 ** 40 + 3, 16)
    kept = [i for i in range(2000) if a(i)]
    assert kept[:16] == list(range(16))
    assert 60 < len(kept) - 16 < 200
    b = harness.check_sample(2 ** 40 + 3, 16)
    assert kept == [i for i in range(2000) if b(i)]
    c = harness.check_sample(2 ** 40 + 4, 16)
    assert kept != [i for i in range(2000) if c(i)]


def test_a_delivery_off_the_schedule_raises():
    clock = _Clock()

    class Skipper(_Stub):       # delivers frame 1 first, reporting no drop
        def run(self, n, realtime=False, with_outlines=True):
            yield "out", SimpleNamespace(frame_id=1, frames_dropped=0)

    with pytest.raises(RuntimeError):
        drive.open_loop(Skipper(clock, 4, []), 10.0, 1.0, clock=clock)
    assert drive.percentile([3, 1, 2, 4], 50) == 2
    assert drive.percentile(list(range(1, 101)), 95) == 95


def test_readers_on_a_trace(spec):
    events = [{"name": "lidarbench.window", "ph": "X", "ts": 1000.0,
               "dur": 10000.0, "cat": "user_annotation"},
              {"name": "void tier_min_d2_kernel(float const*)", "ph": "X",
               "cat": "kernel", "ts": 900.0, "dur": 300.0},
              {"name": "elementwise", "ph": "X", "cat": "kernel",
               "ts": 1100.0, "dur": 2000.0},
              {"name": "union_find_kernel", "ph": "X", "cat": "kernel",
               "ts": 6000.0, "dur": 1000.0},
              {"name": "Memcpy DtoH", "ph": "X", "cat": "gpu_memcpy",
               "ts": 10900.0, "dur": 500.0},
              {"name": "cudaEventSynchronize", "ph": "X",
               "cat": "cuda_runtime", "ts": 3200.0, "dur": 2700.0},
              {"name": "lidarbench.resume_run", "ph": "X",
               "cat": "user_annotation", "ts": 3000.0, "dur": 4000.0}]
    tr = parse(events, frames=2)
    # busy: [1000, 1200] + [1100, 3100] + [6000, 7000] + [10900, 11000]
    assert tr.busy_s() == pytest.approx((2100 + 1000 + 100) * 1e-6)
    assert tr.window_s == pytest.approx(0.01)
    ctx = harness.Context([SimpleNamespace(t_dispatch_ms=4.0, t_host_ms=1.5),
                           SimpleNamespace(t_dispatch_ms=6.0, t_host_ms=2.5)],
                          tr)
    read = {m: spec.reader(m)(ctx) for m in (
        "dispatch_ms.live", "host_stage_ms.replay", "step_device_ms.replay",
        "device_idle_share.replay", "hand_kernel_ms.replay")}
    assert read["dispatch_ms.live"] == 5.0
    assert read["host_stage_ms.replay"] == 2.0
    assert read["step_device_ms.replay"] == pytest.approx(
        (200 + 2000 + 1000 + 100) * 1e-3 / 2)
    assert read["device_idle_share.replay"] == pytest.approx(68.0)
    assert read["hand_kernel_ms.replay"] == pytest.approx(0.6)
    br = tr.breakdown()
    assert br["device_ops"][0] == ["elementwise", pytest.approx(0.002)]
    # the longest gap has no span but the window's; the next, a wait
    assert br["idle_gaps"] == [["lidarbench.window", pytest.approx(0.0039)],
                               ["cudaEventSynchronize", pytest.approx(0.0029)]]
    empty = harness.Context([], None)
    assert all(spec.reader(m["name"])(empty) is None
               for m in spec.bench["per_layer"])


def test_benchmark_json_keeps_to_the_contract(spec):
    b = spec.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["lidarbench"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert cells == 2 and len(json.dumps(b)) < 64 * 1024


def test_the_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "lidarbench.run", "--workload",
                        "kitti-hdl64e-host-outlines.live-10hz", "--seed", "5",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "CUDA card" in r.stderr
