"""The comparison that decides ``correct`` fails what it must.

A whole run of a cell on the CPU at a small size (16 beams, 4096-point
caps; the harness's look for a card is the command's and is skipped
here): sound, it is correct; with the timed path broken underneath in
each way the cells can break, it is not: the state left at its first
frame, half of each cloud left out, an outline moved where it is made,
and the program's own convex outlines in place of the chi-shapes the
configuration asks for. And the control, the reference computed on
bfloat16 coordinates in the program's place, is not correct either. The cells run on one card, so no exchange between
cards can be left out.
"""

import dataclasses
import sys
import time
import types

import numpy as np
import pytest

from lidarbench import check, harness
from lidarbench.tests.small import small_config, small_limits, small_traffic

CELL = "kitti-hdl64e-host-outlines.replay-max"


class _Wrapped:
    """A stream whose deliveries pass through ``alter(out, index)``."""

    def __init__(self, stream, alter):
        self._s, self._alter = stream, alter

    def __getattr__(self, name):
        return getattr(self._s, name)

    def run(self, *args, **kwargs):
        for k, (out, m) in enumerate(self._s.run(*args, **kwargs)):
            yield self._alter(out, k), m


def _stale(stream):
    first = []

    def alter(out, k):        # the state never moves past the first frame
        first.append(out)
        return first[0]
    return _Wrapped(stream, alter)


def _half_left_out(stream):
    for f, n in enumerate(stream.counts):
        stream.mask[f, int(n) // 2:] = False
    return stream


def _outline_moved(stream):
    def alter(out, k):        # one outline shifted 5 cm where it is made
        outlines = list(out.outlines)
        outlines[k % len(outlines)] = outlines[k % len(outlines)] + \
            np.float32([0.05, 0.0])
        return out._replace(outlines=outlines)
    return _Wrapped(stream, alter)


def _run(spec, hook=None, seed=2 ** 33 + 17, concave=True):
    cfg = small_config()
    cfg["engine"]["polygonization"] = dict(
        cfg["engine"]["polygonization"], polygonizer_concave=concave)
    tr = small_traffic(spec, CELL)
    return harness.run_cell(spec, CELL, seed, 1.5, False, time.perf_counter(),
                            device="cpu", config=cfg, traffic=tr,
                            limits=small_limits(spec), stream_hook=hook)


def test_a_sound_run_is_correct(spec):
    res = _run(spec)
    assert res.line["correct"], res.check_lines
    assert res.line["attempted"] >= 2 and res.line["failed"] == 0
    assert list(res.line)[-1] == "checks"
    assert res.line["checks"]["overflow"]["value"] == 0


@pytest.mark.parametrize("fault", [_stale, _half_left_out, _outline_moved],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_a_broken_path_is_not_correct(spec, fault):
    res = _run(spec, fault)
    assert not res.line["correct"], res.check_lines


def test_convex_outlines_are_not_correct(spec):
    # the program's convex path, which a faster host stage could take:
    # clusters, labels and containment all hold; the shapes do not
    res = _run(spec, concave=False)
    assert not res.line["correct"], res.check_lines
    numbers = {k: v["value"] for k, v in res.line["checks"].items()}
    assert numbers["cluster_mismatch_share"] == 0.0
    assert numbers["outline_area_gap_share"] > \
        small_limits(spec)["outline_area_gap_share"]


def test_the_control_is_not_correct(spec):
    cfg = small_config()
    tr = small_traffic(spec, CELL)
    engine = dataclasses.asdict(harness.engine_config(cfg, tr))
    for seed in (3, 4, 5):
        frames = [f[0] for f in harness.make_frames(cfg, seed, 3)]
        v = check.judge(frames, [(i, check.control(x, engine))
                                 for i, x in enumerate(frames)],
                        engine, small_limits(spec))
        assert not v.correct, v.numbers


def test_jax_loaded_in_a_run_stops_it(spec):
    def load_jax(stream):
        sys.modules["jax"] = types.ModuleType("jax")
        return stream
    try:
        with pytest.raises(harness.ForbiddenImport):
            _run(spec, load_jax)
    finally:
        sys.modules.pop("jax", None)
