"""Small-scale settings for the benchmark's CPU tests."""

import copy

from lidarbench.spec import Spec

CAP = 4096


def small_config(name: str = "kitti-hdl64e-host-outlines") -> dict:
    """A configuration's file with a 16-beam sensor, a short street and
    caps for 4096 points: a few-thousand-point sweep the CPU steps in a
    fraction of a second."""
    cfg = copy.deepcopy(Spec().config(name))
    cfg["sensor"].update(
        elevation_blocks=[[2.0, -8.33, 8], [-8.83, -24.33, 8]],
        azimuth_steps=240, max_range_m=25.0)
    cfg["street"].update(half_length_m=22.0, cars=10, pedestrians=16,
                         poles=6, bushes=16, clutter=20, facade_segments=4)
    pipe = dict(cfg["engine"].get("pipeline", {}))
    pipe.update(max_points=CAP, max_obstacle_points=CAP, max_cells=2048,
                max_columns=1024, max_supernodes=2048,
                max_column_pairs=8192, max_sn_pairs=8192)
    cfg["engine"] = dict(cfg["engine"], pipeline=pipe)
    return cfg


def small_traffic(spec, workload: str, frames: int = 3) -> dict:
    tr = copy.deepcopy(spec.traffic(spec.workload(workload)["traffic"]))
    tr["resident_frames"] = frames
    tr["trace"] = {"skip_frames": 1, "frames": 2}
    return tr


def small_limits(spec, name: str = "kitti-hdl64e-host-outlines") -> dict:
    """The configuration's limits, with those of the outlines' area set
    for the small sweeps: their clusters are a few points each, so the
    payload's grid turns more of their chi-shapes (sound runs on the CPU
    read up to 0.139 and 0.071, the convex outlines 1.03 and 0.43)."""
    return dict(spec.limits(name), outline_area_gap_share=0.3,
                outline_miss_share=0.2)
