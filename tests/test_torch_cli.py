"""PyTorch port: the CLI (``python -m lidar_processing_tpu_torch``) and
the entry points behind it — run, bench, golden — on the CPU, over small
synthetic frames written as PCD files."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lidar_processing_tpu_torch import bench, cli
from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
from lidar_processing_tpu_torch.io.export import read_ply_xyzrgb
from lidar_processing_tpu_torch.io.pcd import write_pcd_xyzi
from lidar_processing_tpu_torch.io.synthetic import street_scene
from lidar_processing_tpu_torch.tools import bench_batch, golden_run

_REPO = pathlib.Path(cli.__file__).resolve().parents[1]
CAP = 4096
CFG = DEFAULT_CONFIG.replace(pipeline=dataclasses.replace(
    DEFAULT_CONFIG.pipeline, max_points=CAP, max_obstacle_points=CAP,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192))
# the root bench.py's JSON keys
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_frame",
              "batch", "ms_per_frame_b1", "ms_per_frame_e2e",
              "host_outline_ms_p50", "e2e_vs_budget", "n_frames",
              "outlines_per_frame", "ground_iou_min", "cluster_f1_min",
              "fec_quality05_f1_min", "backend"}


@pytest.fixture(autouse=True)
def small_config(monkeypatch):
    """The entry points run the default config; here, a narrow one."""
    for mod in (cli, bench, golden_run, bench_batch):
        monkeypatch.setattr(mod, "DEFAULT_CONFIG", CFG)


@pytest.fixture
def frames(tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    for seed in (0, 1):
        write_pcd_xyzi(d / f"{seed:06d}.pcd", *street_scene(seed, "small"))
    return d


def _wedge(tmp_path):
    """One small frame that meets the whole golden contract: a 12-degree
    wedge (3972 points) of a full-size synthetic sweep. (The "small"
    scenes are too sparse: FEC agrees with itself under reordering better
    than with exact clustering there, which check 6 counts a violation.)"""
    xyz, inten = street_scene(0)
    az = np.degrees(np.arctan2(xyz[:, 1], xyz[:, 0]))
    keep = (az >= -150) & (az < -138)
    d = tmp_path / "wedge"
    d.mkdir()
    write_pcd_xyzi(d / "000000.pcd", xyz[keep], inten[keep])
    return d


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def test_run_with_stage_timing_and_export(frames, tmp_path, capsys):
    out_dir = tmp_path / "export"
    rc = cli.main(["run", "--device", "cpu", "--data-dir", str(frames),
                   "--frames", "3", "--stage-timing", "--export-dir",
                   str(out_dir), "--export-frames", "1"])
    assert rc == 0
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if ln.startswith("frame ")]
    assert [ln.split(":")[0] for ln in lines] == ["frame   0", "frame   1",
                                                   "frame   0"]
    assert all(" seg=" in ln and " hull=" in ln for ln in lines)
    assert "3 frames: dispatch p50=" in text and "overflow_frames=0" in text
    names = sorted(p.name for p in out_dir.iterdir())
    assert names == ["frame_0001_clustered.ply", "frame_0001_ground.ply",
                     "frame_0001_obstacle.ply", "frame_0001_polygons.json"]
    xyz, rgb, inten = read_ply_xyzrgb(str(out_dir / "frame_0001_ground.ply"))
    assert xyz.shape[0] == rgb.shape[0] == inten.shape[0] > 1000
    polys = json.loads((out_dir / "frame_0001_polygons.json").read_text())
    clusters = int(lines[1].split("clusters=")[1].split()[0])
    assert polys["frame"] == 1 and len(polys["polygons"]) == clusters > 3


def test_bench_prints_one_json_line(frames, tmp_path, capsys):
    golden = tmp_path / "golden.json"
    golden.write_text(json.dumps({"n_frames": 2, "iou_min": 1.0,
                                  "f1_min": 1.0, "violations": []}))
    rc = cli.main(["bench", "--device", "cpu", "--data-dir", str(frames),
                   "--golden", str(golden)])
    assert rc == 0
    (res,) = _json_lines(capsys.readouterr().out)
    assert BENCH_KEYS | {"golden_154", "device", "step"} == set(res)
    # the CPU has no CUDA graphs: its route is the eager step
    assert res["step"] == "eager"
    # batch: the best of B = 1 and the default batched B = 4, 8 (over the
    # 2 frames repeated cyclically)
    assert res["backend"] == "cpu" and res["batch"] in {1, 4, 8}
    assert 0 < res["ms_per_frame"] <= res["ms_per_frame_b1"]
    assert res["value"] == pytest.approx(1000.0 / res["ms_per_frame"])
    assert res["n_frames"] == 2 and res["outlines_per_frame"] > 3
    assert res["ground_iou_min"] == 1.0 and res["cluster_f1_min"] == 1.0
    assert res["golden_154"] == {"n_frames": 2, "iou_min": 1.0,
                                 "f1_min": 1.0}


def test_bench_batch_prints_ms_per_frame(frames, capsys):
    """tools/bench_batch.py's counterpart: one line per B, on the CPU here
    (its default is the card)."""
    out = bench_batch.main(["--device", "cpu", "--data-dir", str(frames),
                            "--batches", "2", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "backend=cpu step=eager frames=2"
    assert [ln.split(":")[0] for ln in lines[1:]] == ["B=  2", "B=  3"]
    assert all("ms/frame" in ln and "fps)" in ln for ln in lines[1:])
    assert sorted(out) == [2, 3] and all(v > 0 for v in out.values())


def test_eager_flag_is_the_cpu_route(frames, capsys):
    """``--eager`` asks for the eager step; on the CPU, which has no CUDA
    graphs, it is the route taken with or without the flag."""
    assert cli.main(["run", "--device", "cpu", "--eager", "--data-dir",
                     str(frames), "--frames", "1"]) == 0
    assert "1 frames: dispatch p50=" in capsys.readouterr().out
    bench_batch.main(["--device", "cpu", "--eager", "--data-dir",
                      str(frames), "--batches", "2"])
    assert capsys.readouterr().out.splitlines()[0] == \
        "backend=cpu step=eager frames=2"


def test_golden_passes_on_a_small_frame(tmp_path, capsys):
    out = tmp_path / "g.json"
    rc = cli.main(["golden", "--device", "cpu", "--data-dir",
                   str(_wedge(tmp_path)), "--out", str(out)])
    assert rc == 0, capsys.readouterr().out
    summary = json.loads(out.read_text())
    assert summary["n_frames"] == 1 and summary["violations"] == []
    assert summary["cluster_exact_frames"] == 1
    assert summary["overflow_frames"] == 0


def test_golden_exit_code_on_a_violation(frames, tmp_path, capsys):
    """The "small" scenes break check 6 (see _wedge): exit code 1."""
    out = tmp_path / "g.json"
    rc = cli.main(["golden", "--device", "cpu", "--data-dir", str(frames),
                   "--out", str(out)])
    assert rc == 1
    assert "FAIL" in capsys.readouterr().out
    summary = json.loads(out.read_text())
    assert summary["cluster_exact_frames"] == 2
    assert summary["violations"][-1]["frame"] == -1


def test_needs_a_gpu_unless_told_cpu(frames, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("run", "bench", "golden"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([cmd, "--data-dir", str(frames)])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_batch.main(["--data-dir", str(frames)])


def test_module_entry_point(frames):
    """python -m lidar_processing_tpu_torch: the card by default, so on a
    machine without one it fails, naming the way out."""
    proc = subprocess.run(
        [sys.executable, "-m", "lidar_processing_tpu_torch", "run",
         "--data-dir", str(frames), "--frames", "1"],
        capture_output=True, text=True, timeout=300, cwd=_REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
