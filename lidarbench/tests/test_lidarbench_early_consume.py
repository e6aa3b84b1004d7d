"""The reader of ``early_consume_share.live`` against stub
``FrameMetrics``: the share of the window's delivered frames with
``consumed_early``, over the frames that carry the field, None where
none does (a program without it) and on no frames."""

from types import SimpleNamespace

import pytest

from lidarbench import harness

METRIC = "early_consume_share.live"


@pytest.mark.parametrize("flags, want", [
    ([True, False, True, True], 75.0),
    ([True, None, False, None], 50.0),     # None: a frame without it
    ([False, False], 0.0),
    ([True], 100.0),
    ([None, None], None),                  # the parent's FrameMetrics
    ([], None)])                           # an empty window
def test_early_consume_share_reads_the_flag(spec, flags, want):
    frames = [SimpleNamespace(t_dispatch_ms=1.0) if f is None
              else SimpleNamespace(t_dispatch_ms=1.0, consumed_early=f)
              for f in flags]
    got = spec.reader(METRIC)(harness.Context(frames, None))
    assert got == (None if want is None else pytest.approx(want))


def test_early_consume_share_is_declared_for_the_live_cell(spec):
    entry = {m["name"]: m for m in spec.bench["per_layer"]}[METRIC]
    assert entry == {
        "name": METRIC, "unit": "%", "better": "higher",
        "source": "program_counter",
        "layer": "runtime: runtime/stream.py ReplayStream, the depth-2 window",
        "moves": "deadline_met_share",
        "workloads": ["kitti-hdl64e-host-outlines.live-10hz"]}
