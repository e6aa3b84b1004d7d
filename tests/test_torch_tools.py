"""PyTorch port: the cap and stage tools (``python -m
lidar_processing_tpu_torch.tools.measure_caps | tier_hist |
profile_stages``) run to their end on the CPU over small synthetic frames
written as PCD files, each printing and returning its tables; so does the
scaling bench (``tools.scaling_bench``) on its own small frames.
tests/test_torch_stixel.py holds their per-frame quantities against the
JAX tools' computations."""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
from lidar_processing_tpu_torch.io.pcd import write_pcd_xyzi
from lidar_processing_tpu_torch.io.synthetic import street_scene
from lidar_processing_tpu_torch.tools import (measure_caps, profile_stages,
                                              scaling_bench, tier_hist)

CFG = DEFAULT_CONFIG.replace(pipeline=dataclasses.replace(
    DEFAULT_CONFIG.pipeline, max_points=4096, max_obstacle_points=4096,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192))


@pytest.fixture(autouse=True)
def small_config(monkeypatch):
    """The tools run the default config; here, a narrow one."""
    for mod in (measure_caps, tier_hist, profile_stages):
        monkeypatch.setattr(mod, "DEFAULT_CONFIG", CFG)


@pytest.fixture
def frames(tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    for seed in (0, 1):
        write_pcd_xyzi(d / f"{seed:06d}.pcd", *street_scene(seed, "small"))
    return d


def test_measure_caps_main(frames, capsys):
    """The cap tool over a frame directory on the CPU: the maxima of every
    capacity-bound quantity, under the small config's caps; without
    --device it needs the card."""
    maxima = measure_caps.main(["--data-dir", str(frames), "--device", "cpu"])
    assert "=== maxima over 2 frames (cpu) ===" in capsys.readouterr().out
    assert int(maxima["overflow"]) == 0 and int(maxima["num"]) > 3
    assert 0 < int(maxima["n_live"]) <= int(maxima["n_edges"])
    assert int(maxima["n_obst"]) <= CFG.pipeline.max_obstacle_points
    assert maxima["tiers2"].shape == (7,) and maxima["n_cls"].shape == (4,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            measure_caps.main(["--data-dir", str(frames)])


def test_measure_caps_over_a_configurations_sweeps(frames):
    """measure over frames given with an engine configuration, at
    widened(cfg, 2): every capacity of CAPS doubled, the obstacle buffer
    at most the padded frame; cap_table sets each maximum beside the
    configuration's cap and 1.2x the maximum rounded up to 32, the tier
    tables and bands a row each entry."""
    from lidar_processing_tpu_torch.io.dataset import list_frames, load_frame
    from lidar_processing_tpu_torch.ops import stixel as tsx
    wide = measure_caps.widened(CFG, 2)
    assert wide.pipeline.max_cells == 2 * CFG.pipeline.max_cells
    assert wide.pipeline.max_obstacle_points == CFG.pipeline.max_points
    assert wide.pipeline.intra_tier_slots == tuple(
        2 * s for s in CFG.pipeline.intra_tier_slots)
    assert wide.pipeline.large_cluster_slots == 1024
    paths = list_frames(str(frames))
    maxima = measure_caps.measure(((p, load_frame(p)[0]) for p in paths),
                                  wide, torch.device("cpu"))
    assert int(maxima["overflow"]) == 0
    rows = {name: (v, cap, sized) for name, v, cap, sized
            in measure_caps.cap_table(maxima, CFG)}
    n_obst = int(maxima["n_obst"])
    assert rows["n_obst"] == (n_obst, 4096, -(-n_obst * 12 // 320) * 32)
    assert rows["tiers1[0]"][1] == CFG.pipeline.intra_tier_slots[0]
    assert rows["tiers1[6]"][1] == tsx._CHUNK_PAIRS_INTRA
    assert rows["tiers2[3]"][1] == tsx._TIERS_SNP[3][2]
    assert rows["n_cls[3]"][1] == CFG.pipeline.expansion_band_caps[3]
    assert rows["num"][1] == CFG.pipeline.large_cluster_slots
    assert 0 < int(maxima["n_clustered"]) <= n_obst


def test_tier_hist_main(frames, capsys):
    out = tier_hist.main(["--data-dir", str(frames), "--device", "cpu",
                          "--step", "1"])
    text = capsys.readouterr().out
    assert "frames sampled: 2 (cpu)" in text and "snp 2D MAX counts" in text
    assert out["frames"] == 2 and out["intra_total"].sum() > 0
    assert np.all(out["intra_max"] <= out["intra_total"])
    assert np.all(out["snp_max"] <= out["snp_total"])
    assert out["snp_2d_max"].shape == (len(tier_hist.BINS) - 1,) * 2


def test_profile_stages_main(frames, capsys):
    out = profile_stages.main(["--data-dir", str(frames), "--device", "cpu",
                               "--frames", "1", "--substages"])
    text = capsys.readouterr().out
    assert "device=cpu (host clock, CPU) frames=1" in text
    assert {"full", "1", "2", "3", "4"} <= out.keys()
    assert all(out[k] > 0 for k in ("full", "1", "2", "3", "4"))
    assert list(out["2_parts"]) == [
        "_sort_points_full", "_build_cells", "_tiered_exact#1",
        "_tiered_exact#2", "_build_supernodes", "_column_pairs", "cc_labels"]
    assert list(out["3_parts"]) == ["label_runs_presorted", "gather_runs",
                                    "convex_hulls_batched"]


def test_scaling_bench_main_small_on_the_cpu(capsys):
    """The data axis at 1, 2, 4 and 8 shards and the 2 x 4 mesh over 8
    frames of 1024 points, one CPU rank: each timed, the layout printed
    first; without --device it needs the card."""
    out = scaling_bench.main(["--device", "cpu", "--max-points", "1024",
                              "--reps", "1", "--frames-per-shard", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("layout: 1 rank(s), process group backend "
                               "none, cpu (host CPU)")
    assert [line.split(" shards ")[0] for line in lines[1:5]] == [
        f"data axis: 8 frames on {n}" for n in (1, 2, 4, 8)]
    assert lines[5].startswith("2-D mesh (2 data x 4 space shards")
    assert set(out["data"]) == {1, 2, 4, 8}
    assert min(out["data"].values()) > 0
    assert out["mesh_2d"] > 0 and out["layout"]["ranks"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            scaling_bench.main([])
