"""On the card: every cell's run is correct; the control, and the
program's own convex outlines in place of the chi-shapes, are not.

    python -m pytest -p no:cacheprovider lidarbench/tests/test_lidarbench_card.py

Skips where there is no CUDA card.
"""

import dataclasses
import time

import pytest

from lidarbench import check, harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kitti-hdl64e-host-outlines.live-10hz",
                                  "kitti-hdl64e-host-outlines.replay-max"])
def test_a_short_run_of_each_cell_is_correct(spec, card, cell):
    res = harness.run_cell(spec, cell, 2 ** 31 + 77, 3.0, False,
                           time.perf_counter(), device=card)
    assert res.line["correct"], res.check_lines
    assert res.line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name,traffic", [("kitti-hdl64e-host-outlines", "live-10hz")])
def test_the_control_fails_at_full_size(spec, card, name, traffic):
    cfg = spec.config(name)
    engine = dataclasses.asdict(harness.engine_config(
        cfg, spec.traffic(traffic)))
    frames = [f[0] for f in harness.make_frames(cfg, 2 ** 31 + 78, 4)]
    v = check.judge(frames, [(i, check.control(x, engine, card))
                             for i, x in enumerate(frames)],
                    engine, spec.limits(name), card)
    assert not v.correct, v.numbers


@pytest.mark.cuda
def test_convex_outlines_fail_at_full_size(spec, card):
    cell = "kitti-hdl64e-host-outlines.replay-max"
    cfg = spec.config("kitti-hdl64e-host-outlines")
    cfg = dict(cfg, engine=dict(cfg["engine"], polygonization=dict(
        cfg["engine"]["polygonization"], polygonizer_concave=False)))
    res = harness.run_cell(spec, cell, 2 ** 31 + 79, 3.0, False,
                           time.perf_counter(), device=card, config=cfg)
    assert not res.line["correct"], res.check_lines
    assert res.line["checks"]["cluster_mismatch_share"]["value"] == 0.0
