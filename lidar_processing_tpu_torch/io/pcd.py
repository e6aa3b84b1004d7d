"""Binary PCD v0.7 reader/writer.

The reference loads frames with ``pcl::io::loadPCDFile`` (ref:
src/dataloader.cpp:137) and re-emits them as x/y/z/intensity FLOAT32 messages
(ref: src/dataloader.cpp:106-125). The bundled dataset is 154 binary PCD v0.7
files with fields ``x y z intensity``, all FLOAT32 COUNT 1, HEIGHT 1.

This module parses that format directly with numpy (zero-copy view over the
payload). A copy of ``lidar_processing_tpu/io/pcd.py`` on a jax-free import
path for the PyTorch port; tests/test_torch_pipeline.py holds the reader
and writer against the original.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Tuple

import numpy as np

_HEADER_KEYS = (
    "VERSION", "FIELDS", "SIZE", "TYPE", "COUNT", "WIDTH", "HEIGHT",
    "VIEWPOINT", "POINTS", "DATA",
)

_TYPE_MAP = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
             ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def _parse_header(data: bytes) -> Tuple[Dict[str, List[str]], int]:
    """Parse the ASCII header; returns (fields dict, payload offset)."""
    header: Dict[str, List[str]] = {}
    offset = 0
    stream = io.BytesIO(data)
    while True:
        line = stream.readline()
        if not line:
            raise ValueError("unterminated PCD header")
        offset += len(line)
        text = line.decode("ascii", errors="replace").strip()
        if not text or text.startswith("#"):
            continue
        parts = text.split()
        key = parts[0].upper()
        if key in _HEADER_KEYS:
            header[key] = parts[1:]
            if key == "DATA":
                return header, offset
        else:
            raise ValueError(f"unexpected PCD header line: {text!r}")


def read_pcd(path: str | os.PathLike) -> Dict[str, np.ndarray]:
    """Read a PCD file; returns dict of field name -> (n,) array.

    Supports binary and ascii DATA with scalar (COUNT 1) fields, which covers
    the bundled dataset and the reference's output schema.
    """
    with open(path, "rb") as f:
        data = f.read()
    header, offset = _parse_header(data)

    fields = header["FIELDS"]
    sizes = [int(s) for s in header["SIZE"]]
    typs = header["TYPE"]
    counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
    n_points = int(header["POINTS"][0])
    mode = header["DATA"][0].lower()

    if any(c != 1 for c in counts):
        raise ValueError("COUNT != 1 fields not supported")

    dtype = np.dtype({
        "names": fields,
        "formats": ["<" + _TYPE_MAP[(t, s)] for t, s in zip(typs, sizes)],
    })

    if mode == "binary":
        payload = data[offset:offset + n_points * dtype.itemsize]
        if len(payload) < n_points * dtype.itemsize:
            raise ValueError(f"truncated PCD payload in {path}")
        rec = np.frombuffer(payload, dtype=dtype, count=n_points)
    elif mode == "ascii":
        rec = np.loadtxt(io.BytesIO(data[offset:]), dtype=dtype, ndmin=1)
        if rec.shape[0] != n_points:
            raise ValueError("ascii PCD point-count mismatch")
    else:
        raise ValueError(f"unsupported DATA mode {mode!r}")

    return {name: np.ascontiguousarray(rec[name]) for name in fields}


def read_pcd_xyzi(path: str | os.PathLike) -> Tuple[np.ndarray, np.ndarray]:
    """Read an x/y/z/intensity cloud; returns ((n,3) f32 xyz, (n,) f32 intensity)."""
    f = read_pcd(path)
    xyz = np.stack([f["x"], f["y"], f["z"]], axis=1).astype(np.float32)
    inten = f.get("intensity")
    if inten is None:
        inten = np.zeros((xyz.shape[0],), np.float32)
    return xyz, inten.astype(np.float32)


def write_pcd_xyzi(path: str | os.PathLike, xyz: np.ndarray,
                   intensity: np.ndarray | None = None) -> None:
    """Write a binary PCD v0.7 with fields x y z intensity (the reference's
    message schema, ref: src/dataloader.cpp:106-125)."""
    n = xyz.shape[0]
    if intensity is None:
        intensity = np.zeros((n,), np.float32)
    rec = np.empty(n, dtype=np.dtype([("x", "<f4"), ("y", "<f4"),
                                      ("z", "<f4"), ("intensity", "<f4")]))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["intensity"] = intensity
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
        f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
