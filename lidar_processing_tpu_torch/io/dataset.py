"""KITTI frame dataset: enumerate, preload, and pad frames.

The reference's dataloader node enumerates ``data/*.pcd`` sorted by name,
preloads every frame into memory at startup, and replays them cyclically at
10 Hz (ref: src/dataloader.cpp:53-67, :128-148, :155-175). This module is the
host-side equivalent; the device-resident replay loop lives in runtime/stream.py.
A copy of ``lidar_processing_tpu/io/dataset.py`` on a jax-free import path;
the default data directory is the checkout's ``data/``.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..io.pcd import read_pcd_xyzi

DEFAULT_DATA_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "data")


def list_frames(data_dir: str = DEFAULT_DATA_DIR) -> List[str]:
    """Sorted list of .pcd paths (ref: src/dataloader.cpp:53-67)."""
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(f"data directory not found: {data_dir}")
    paths = sorted(
        os.path.join(data_dir, f) for f in os.listdir(data_dir)
        if f.endswith(".pcd")
    )
    if not paths:
        raise FileNotFoundError(f"no .pcd files in {data_dir}")
    return paths


def load_frame(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(n,3) xyz float32, (n,) intensity float32 for one frame."""
    return read_pcd_xyzi(path)


def preload_padded(
    paths: Sequence[str], capacity: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Preload frames into padded arrays.

    Returns (xyz [F, capacity, 3] f32, intensity [F, capacity] f32,
    counts [F] int32). Padded entries are zero. The stacked arrays are small
    enough (154 x 131072 x 4 floats ~ 260 MB) to live device-resident in HBM,
    which removes all host->device transfer from the steady-state replay loop
    (the reference instead crosses a DDS process boundary per frame,
    ref: src/dataloader.cpp:170).
    """
    num = len(paths)
    xyz = np.zeros((num, capacity, 3), np.float32)
    inten = np.zeros((num, capacity), np.float32)
    counts = np.zeros((num,), np.int32)
    for i, p in enumerate(paths):
        fx, fi = load_frame(p)
        n = fx.shape[0]
        if n > capacity:
            raise ValueError(f"{p}: {n} points exceeds capacity {capacity}")
        xyz[i, :n] = fx
        inten[i, :n] = fi
        counts[i] = n
    return xyz, inten, counts
