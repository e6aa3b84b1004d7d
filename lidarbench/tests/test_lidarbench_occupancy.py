"""The capacity-share readers (``lidarbench/occupancy.py``) against stub
``FrameMetrics``: the mean over the window's delivered frames of each
frame's count over its cap, in %, and None on frames that lack the
counters (a program without them) and on no frames; and their entries in
BENCHMARK.json."""

from types import SimpleNamespace

import pytest

from lidarbench import harness

SHARES = {"obstacle_fill_share.replay": ("obstacle_points", "obstacle_slots"),
          "tier_slot_peak_share.replay": ("tier_peak_pairs",
                                          "tier_peak_slots"),
          "outline_slot_share.replay": ("outline_clusters", "outline_slots")}
CELLS = ["kitti-hdl64e-host-outlines.replay-max",
         "waymo-top64-host-outlines.replay-max"]


def _frame(count: int, cap: int):
    return SimpleNamespace(counters={
        name: v for pair in SHARES.values()
        for name, v in zip(pair, (count, cap))})


def test_share_readers_on_stub_frames(spec):
    """Frames at 1/4 and 3/5 of caps 100 and 50: shares 25% and 60%."""
    ctx = harness.Context([_frame(25, 100), _frame(30, 50)], None)
    for metric in SHARES:
        assert spec.reader(metric)(ctx) == pytest.approx(42.5), metric


def test_share_readers_find_nothing_without_the_counters(spec):
    """The parent's FrameMetrics (counters without these, or none at
    all), no frames, and a zero cap read None."""
    parent = harness.Context([
        SimpleNamespace(counters={"tier_pairs": 3, "uf_edges": 2}),
        SimpleNamespace(t_dispatch_ms=4.0)], None)
    for ctx in (parent, harness.Context([], None),
                harness.Context([_frame(3, 0)], None)):
        for metric in SHARES:
            assert spec.reader(metric)(ctx) is None, metric


def test_share_metrics_are_declared_for_both_replay_cells(spec):
    entries = {m["name"]: m for m in spec.bench["per_layer"]}
    for name in SHARES:
        m = entries[name]
        assert m["workloads"] == CELLS and m["unit"] == "%"
        assert m["moves"] == "frames_per_s"
        assert m["source"] == "program_counter"
    for cell in CELLS:
        assert set(SHARES) <= {m["name"] for m in spec.per_layer(cell)}
