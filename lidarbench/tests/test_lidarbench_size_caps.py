"""size_caps: a configuration's own sweeps through its engine, on the
CPU, at a small sensor row and the small caps."""

import dataclasses
import json
import os

from lidar_processing_tpu_torch.config import DEFAULT_CONFIG

from lidarbench import size_caps
from lidarbench.spec import HERE


def test_size_caps_over_a_configurations_sweeps(tmp_path, capsys):
    """--config: the configuration's sweeps at --widen 2; each cap's row
    holds the maximum, the configuration's value and 1.2x the maximum
    rounded up to 32."""
    with open(os.path.join(HERE, "configs",
                           "kitti-hdl64e-host-outlines.json")) as f:
        config = json.load(f)
    pcfg = dataclasses.replace(
        DEFAULT_CONFIG.pipeline, max_points=4096, max_obstacle_points=4096,
        max_cells=2048, max_columns=1024, max_supernodes=2048,
        max_column_pairs=8192, max_sn_pairs=8192)
    caps = {f: getattr(pcfg, f) for f in (
        "max_points", "max_obstacle_points", "max_cells", "max_columns",
        "max_supernodes", "max_column_pairs", "max_sn_pairs")}
    config = dict(config, name="small-row", sensor=dict(
        config["sensor"], elevation_blocks=[[2.0, -24.0, 16]],
        azimuth_steps=256), engine=dict(config["engine"], pipeline=caps))
    path = tmp_path / "small-row.json"
    path.write_text(json.dumps(config))
    maxima = size_caps.main(["--config", str(path), "--streets", "2",
                             "--widen", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "=== maxima over 2 streets (cpu) ===" in text
    assert ("=== caps of small-row (measured at 2.0x its capacities) ==="
            in text)
    assert int(maxima["overflow"]) == 0
    rows = {ln.split()[0]: [int(v) for v in ln.split()[1:]]
            for ln in text.split("===")[-1].splitlines()[2:]}
    n_obst = int(maxima["n_obst"])
    assert rows["n_obst"] == [n_obst, 4096, -(-n_obst * 12 // 320) * 32]
    assert rows["tiers1[0]"][1] == pcfg.intra_tier_slots[0]
    assert rows["num"][1] == pcfg.large_cluster_slots
    assert 0 < int(maxima["n_clustered"]) <= n_obst
