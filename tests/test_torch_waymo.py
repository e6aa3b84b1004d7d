"""PyTorch port: capacities that follow the configuration, and the Waymo
Open Dataset's top LiDAR through the step.

At DEFAULT_CONFIG the tier tables, expansion bands and outline slots the
step derives from PipelineConfig are the JAX package's module constants.
A full-size sweep of the benchmark's ``waymo-top64-host-outlines``
configuration (64 x 2650 rays, ~159k points) goes through the stamped
packed step and the host stage on the CPU and is judged by the
benchmark's own check against the configuration's limits; the same sweep
with any group of those capacities back at DEFAULT_CONFIG's overflows.
"""

import dataclasses
import inspect
import json
import os

import pytest
import torch

from lidar_processing_tpu.ops import stixel as jsx
from lidar_processing_tpu.runtime import pipeline as jpipe
from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
from lidar_processing_tpu_torch.io.synthetic import pad_frame
from lidar_processing_tpu_torch.ops import stixel as tsx
from lidar_processing_tpu_torch.runtime import pipeline as tpipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "waymo-top64-host-outlines"
STREET = 5    # over DEFAULT_CONFIG's obstacle buffer, tiers and outlines


def _json(kind: str):
    with open(os.path.join(ROOT, "lidarbench", kind, f"{NAME}.json")) as f:
        return json.load(f)


def test_default_capacities_are_the_jax_constants():
    pcfg = DEFAULT_CONFIG.pipeline
    assert tsx.tier_tables(pcfg) == (jsx._TIERS_INTRA, jsx._TIERS_SNP)
    # a constant inside the JAX package's clustering core
    assert pcfg.expansion_band_caps == (10240, 3840, 512, 64)
    assert ("_E_CAPS = (10240, 3840, 512, 64)"
            in inspect.getsource(jsx._cluster_core))
    assert (tpipe.SMALL_C, pcfg.large_cluster_slots,
            tpipe.num_slots(DEFAULT_CONFIG)) == (
                jpipe.SMALL_C, jpipe.LARGE_C, jpipe.NUM_SLOTS)


def test_json_lists_become_tuples():
    """A configuration file gives lists; the config stays hashable, and a
    table of the wrong length is refused."""
    pcfg = dataclasses.replace(DEFAULT_CONFIG.pipeline,
                               intra_tier_slots=[1, 2, 3, 4, 5, 6])
    assert pcfg.intra_tier_slots == (1, 2, 3, 4, 5, 6)
    hash(pcfg)
    with pytest.raises(ValueError):
        dataclasses.replace(DEFAULT_CONFIG.pipeline,
                            expansion_band_caps=(1, 2, 3))


@pytest.fixture(scope="module")
def waymo():
    """(engine config, limits, xyz, intensity) of the configuration's
    street STREET, as the benchmark builds them."""
    from lidarbench import harness, scenes
    config = _json("configs")
    ecfg = harness.engine_config(config, {"loop": "closed",
                                          "queue_depth": 2})
    xyz, inten = scenes.street_sweep(STREET, config)
    return ecfg, _json("limits"), xyz, inten


def _step(ecfg, xyz):
    x, m = pad_frame(xyz, ecfg.pipeline.max_points)
    payload, stats = tpipe.device_frame_step_stamped_batched(
        torch.from_numpy(x)[None], torch.from_numpy(m)[None], ecfg)
    counters = dict(zip(tpipe.COUNTERS,
                        stats[0, len(tpipe.STAGES) + 1:].tolist()))
    return payload[0], counters


def test_waymo_sweep_is_correct(waymo):
    """The whole sweep through the stamped packed step and the host
    stage: judged correct against the configuration's limits, overflow
    0, and every capacity share under the 1.2x headroom it was sized
    with."""
    from lidarbench import check
    ecfg, limits, xyz, inten = waymo
    assert 158_000 < xyz.shape[0] <= 64 * 2650 == ecfg.pipeline.max_points
    payload, counters = _step(ecfg, xyz)
    out = tpipe.host_outputs_packed(payload, ecfg, xyz.shape[0],
                                    intensity=inten)
    assert out.overflow == 0 and out.num_clusters > 600
    verdict = check.judge([xyz], [(0, out)], dataclasses.asdict(ecfg),
                          limits)
    assert verdict.correct, verdict.numbers
    assert verdict.numbers["overflow"] == 0
    for count, cap in (("obstacle_points", "obstacle_slots"),
                       ("tier_peak_pairs", "tier_peak_slots"),
                       ("outline_clusters", "outline_slots")):
        assert 0 < counters[count] <= counters[cap] / 1.2, (count, counters)
    assert counters["obstacle_slots"] == ecfg.pipeline.max_obstacle_points
    assert counters["outline_slots"] == ecfg.pipeline.large_cluster_slots
    assert counters["outline_clusters"] == out.num_clusters


@pytest.mark.parametrize("fields", [
    ("intra_tier_slots",),
    ("large_cluster_slots",),
    ("max_obstacle_points", "payload_large_points")])
def test_default_capacities_overflow_on_the_waymo_sweep(waymo, fields):
    """The same sweep with one group of the configuration's capacities
    back at DEFAULT_CONFIG's reports overflow: the caps follow the
    configuration."""
    ecfg, _, xyz, _ = waymo
    pcfg = dataclasses.replace(ecfg.pipeline, **{
        f: getattr(DEFAULT_CONFIG.pipeline, f) for f in fields})
    payload, counters = _step(ecfg.replace(pipeline=pcfg), xyz)
    assert int(payload[3]) > 0
    if fields == ("large_cluster_slots",):
        assert counters["outline_clusters"] > counters["outline_slots"]
    if "max_obstacle_points" in fields:
        assert counters["obstacle_points"] > counters["obstacle_slots"]
    if "intra_tier_slots" in fields:
        assert counters["tier_peak_pairs"] > counters["tier_peak_slots"]
