"""Seeded synthetic street scenes: the port's stand-in for KITTI frames.

A numpy ray caster with the geometry of a 64-beam spinning LiDAR
(HDL-64E-like: 64 beams from +2.0 to -24.3 degrees in two blocks, one
revolution of azimuth steps) mounted 1.73 m above a flat road. Every ray
returns the nearest hit among the ground plane and the scene's objects,
so points lie
on surfaces (never inside volumes), density falls off with range, objects
occlude what lies behind them, and rays that hit nothing within range
return nothing.

The scene is a street along x: cars in lanes and parked at the kerbs,
pedestrians and bushes on the pavements, poles at the kerbs, building
facades (walls thousands of points long) behind the pavements, and
street clutter. At ``size="full"`` a frame has roughly 100k-124k points
(the KITTI range, padded to 131072 by the caller), about 35-45%
obstacles and several hundred clusters, so the large-cluster host path
and the chunked (> 288-point) exact tests both run. ``size="small"`` is a
few-thousand-point scene for the CPU tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SENSOR_HEIGHT = 1.73
_GROUND_Z = -SENSOR_HEIGHT

# per size: (beams, azimuth steps, max range m, street half-length m,
#            cars, pedestrians, poles, bushes, clutter, facade segments)
_SIZES = {
    "full": (64, 1900, 80.0, 70.0, 130, 220, 90, 300, 380, 24),
    "small": (16, 240, 25.0, 22.0, 10, 16, 6, 16, 20, 4),
}


def _boxes(rng, n, x_range, y_choices, size_lo, size_hi, yaw_sd,
           z_bottom=0.0):
    """n boxes: centers (n,3), half sizes (n,3), yaw (n,)."""
    size = rng.uniform(size_lo, size_hi, (n, 3))
    cx = rng.uniform(*x_range, n)
    cy = rng.choice(y_choices, n) + rng.normal(0.0, 0.3, n)
    cz = _GROUND_Z + z_bottom + size[:, 2] / 2
    yaw = rng.normal(0.0, yaw_sd, n)
    return np.stack([cx, cy, cz], 1), size / 2, yaw


def _roadside_y(rng, n: int, scale: float) -> np.ndarray:
    """y of objects between the kerb (8.6 m) and the facades (27 m)."""
    side = rng.choice([-1.0, 1.0], n)
    return side * rng.uniform(8.6, 27.0, n) * max(scale, 0.6)


def _clear_of_sensor(boxes, dx: float, dy: float):
    """Drop boxes centred within (dx, dy) of the sensor."""
    c = boxes[0]
    keep = ~((np.abs(c[:, 0]) < dx) & (np.abs(c[:, 1]) < dy))
    return tuple(a[keep] for a in boxes)


def _scene(rng, size: str):
    beams, n_az, max_range, half_len, n_car, n_ped, n_pole, n_bush, \
        n_clutter, n_facade = _SIZES[size]
    scale = half_len / 70.0
    boxes = []
    # cars: the ego lane (clear for 10 m around the sensor), the oncoming
    # lane and two parking lanes
    cars = _boxes(rng, n_car, (-half_len, half_len),
                  np.array([-7.0, -3.5, 0.0, 3.5]) * max(scale, 0.5),
                  (3.9, 1.6, 1.4), (4.8, 1.9, 1.6), 0.08, z_bottom=0.15)
    boxes.append(_clear_of_sensor(cars, 10.0, 5.0))
    # clutter: bins, boxes, signs on the pavements
    clutter = _boxes(rng, n_clutter, (-half_len, half_len), np.zeros(1),
                     (0.3, 0.3, 0.5), (0.8, 0.8, 1.4), 0.5)
    clutter[0][:, 1] = _roadside_y(rng, n_clutter, scale)
    boxes.append(clutter)
    # building facades behind the pavements, with gaps between them
    fac_c, fac_h, fac_yaw = [], [], []
    for side in (-1.0, 1.0):
        x = -half_len
        for _ in range(n_facade // 2):
            length = rng.uniform(6.0, 16.0) * max(scale, 0.4)
            gap = rng.uniform(1.0, 5.0) * max(scale, 0.4)
            height = rng.uniform(4.0, 12.0)
            y = side * rng.uniform(28.0, 34.0) * max(scale, 0.6)
            fac_c.append([x + length / 2, y, _GROUND_Z + height / 2])
            fac_h.append([length / 2, 0.25, height / 2])
            fac_yaw.append(rng.normal(0.0, 0.02))
            x += length + gap
    boxes.append((np.array(fac_c), np.array(fac_h), np.array(fac_yaw)))
    centers = np.concatenate([b[0] for b in boxes])
    halves = np.concatenate([b[1] for b in boxes])
    yaws = np.concatenate([b[2] for b in boxes])

    # vertical cylinders (cx, cy, r, z0, z1): pedestrians and poles on the
    # roadside
    peds = np.stack([rng.uniform(-half_len, half_len, n_ped),
                     _roadside_y(rng, n_ped, scale),
                     rng.uniform(0.2, 0.3, n_ped),
                     np.full(n_ped, _GROUND_Z),
                     _GROUND_Z + rng.uniform(1.55, 1.9, n_ped)], 1)
    poles = np.stack([rng.uniform(-half_len, half_len, n_pole),
                      _roadside_y(rng, n_pole, scale),
                      rng.uniform(0.07, 0.15, n_pole),
                      np.full(n_pole, _GROUND_Z),
                      _GROUND_Z + rng.uniform(3.5, 8.0, n_pole)], 1)
    # bollards along both kerbs
    n_boll = 2 * n_pole
    bollards = np.stack([rng.uniform(-half_len, half_len, n_boll),
                         rng.choice([-8.0, 8.0], n_boll) * max(scale, 0.6),
                         rng.uniform(0.08, 0.15, n_boll),
                         np.full(n_boll, _GROUND_Z),
                         _GROUND_Z + rng.uniform(0.8, 1.2, n_boll)], 1)
    cyl = np.concatenate([peds, poles, bollards])

    # bushes / tree crowns: spheres (cx, cy, cz, r)
    r = rng.uniform(0.25, 0.7, n_bush)
    bush = np.stack([rng.uniform(-half_len, half_len, n_bush),
                     _roadside_y(rng, n_bush, scale),
                     _GROUND_Z + r * rng.uniform(0.7, 2.5, n_bush), r], 1)
    return (beams, n_az, max_range), (centers, halves, yaws), cyl, bush


def _rays(beams: int, n_az: int, rng) -> np.ndarray:
    # HDL-64E-like: an upper block of half the lasers at 1/3 degree
    # spacing, a lower block at 1/2 degree
    half = beams // 2
    elev = np.deg2rad(np.concatenate([
        np.linspace(2.0, -8.33, half),
        np.linspace(-8.83, -24.33, beams - half)]))
    az = (np.arange(n_az) + rng.uniform()) * (2 * np.pi / n_az)
    el, a = np.meshgrid(elev, az, indexing="ij")
    el = el + rng.normal(0.0, 1e-4, el.shape)
    return np.stack([np.cos(el) * np.cos(a), np.cos(el) * np.sin(a),
                     np.sin(el)], -1).reshape(-1, 3)


def _hit_boxes(d, centers, halves, yaws):
    c, s = np.cos(-yaws), np.sin(-yaws)
    dx = c[None] * d[:, :1] - s[None] * d[:, 1:2]
    dy = s[None] * d[:, :1] + c[None] * d[:, 1:2]
    dz = np.broadcast_to(d[:, 2:3], dx.shape)
    ox = -(c * centers[:, 0] - s * centers[:, 1])
    oy = -(s * centers[:, 0] + c * centers[:, 1])
    oz = -centers[:, 2]
    t_near = np.full(dx.shape, -np.inf)
    t_far = np.full(dx.shape, np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for dd, o, h in ((dx, ox, halves[:, 0]), (dy, oy, halves[:, 1]),
                         (dz, oz, halves[:, 2])):
            t1 = (-h - o) / dd
            t2 = (h - o) / dd
            t_near = np.fmax(t_near, np.fmin(t1, t2))
            t_far = np.fmin(t_far, np.fmax(t1, t2))
    hit = (t_far >= t_near) & (t_near > 0)
    return np.where(hit, t_near, np.inf).min(1, initial=np.inf)


def _hit_cylinders(d, cyl):
    a = d[:, 0:1] ** 2 + d[:, 1:2] ** 2
    b = -2.0 * (d[:, 0:1] * cyl[None, :, 0] + d[:, 1:2] * cyl[None, :, 1])
    c = cyl[:, 0] ** 2 + cyl[:, 1] ** 2 - cyl[:, 2] ** 2
    disc = b * b - 4.0 * a * c[None]
    with np.errstate(invalid="ignore", divide="ignore"):
        t = (-b - np.sqrt(disc)) / (2.0 * a)
    z = t * d[:, 2:3]
    hit = ((disc >= 0) & (t > 0) & (z >= cyl[None, :, 3])
           & (z <= cyl[None, :, 4]))
    return np.where(hit, t, np.inf).min(1, initial=np.inf)


def _hit_spheres(d, sph):
    b = -2.0 * (d @ sph[:, :3].T)
    c = (sph[:, :3] ** 2).sum(1) - sph[:, 3] ** 2
    disc = b * b - 4.0 * c[None]
    with np.errstate(invalid="ignore"):
        t = (-b - np.sqrt(disc)) / 2.0
    return np.where((disc >= 0) & (t > 0), t, np.inf).min(1, initial=np.inf)


def _azimuth_extent(objs: np.ndarray, radius: np.ndarray):
    """(azimuth, half-width) of each object's xy bounding circle as seen
    from the sensor; objects around the sensor get half-width pi."""
    dist = np.hypot(objs[:, 0], objs[:, 1])
    ratio = np.where(dist > radius, radius / np.maximum(dist, 1e-9), 1.0)
    half = np.where(dist > radius, np.arcsin(np.minimum(ratio, 1.0)), np.pi)
    return np.arctan2(objs[:, 1], objs[:, 0]), half


def street_scene(seed: int, size: str = "full"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One frame: ((n, 3) float32 xyz, (n,) float32 intensity).

    Deterministic in `seed`; `size` is "full" (KITTI scale) or "small"
    (a few thousand points, for tests).
    """
    rng = np.random.default_rng(seed)
    (beams, n_az, max_range), boxes, cyl, sph = _scene(rng, size)
    d = _rays(beams, n_az, rng)
    t = np.full(d.shape[0], np.inf)
    kind = np.zeros(d.shape[0], np.int8)          # 0 ground, 1 object
    # rays in azimuth order, in sectors; each sector tests only the objects
    # whose azimuth extent can reach it (a conservative cull: the result is
    # that of testing every object)
    az = np.arctan2(d[:, 1], d[:, 0])
    order = np.argsort(az, kind="stable")
    extents = [_azimuth_extent(boxes[0], np.hypot(*boxes[1][:, :2].T)),
               _azimuth_extent(cyl, cyl[:, 2]),
               _azimuth_extent(sph, sph[:, 3])]
    chunk = 2048
    for lo in range(0, d.shape[0], chunk):
        idx = order[lo:lo + chunk]
        dc = d[idx]
        a0, a1 = az[idx[0]], az[idx[-1]]
        mid, half = (a0 + a1) / 2, (a1 - a0) / 2 + 1e-6
        near = [np.abs(np.angle(np.exp(1j * (phi - mid)))) <= delta + half
                for phi, delta in extents]
        t_obj = np.minimum(np.minimum(
            _hit_boxes(dc, *(a[near[0]] for a in boxes)),
            _hit_cylinders(dc, cyl[near[1]])),
            _hit_spheres(dc, sph[near[2]]))
        with np.errstate(divide="ignore"):
            t_gnd = np.where(dc[:, 2] < 0, _GROUND_Z / dc[:, 2], np.inf)
        t[idx] = np.minimum(t_obj, t_gnd)
        kind[idx] = t_obj < t_gnd
    keep = t <= max_range
    d, t, kind = d[keep], t[keep], kind[keep]
    t = t + rng.normal(0.0, 0.01, t.shape)          # range noise
    xyz = d * t[:, None]
    ground = kind == 0
    xyz[ground, 2] = _GROUND_Z + rng.normal(0.0, 0.02, int(ground.sum()))
    inten = np.where(ground, rng.uniform(0.0, 0.3, t.shape),
                     rng.uniform(0.1, 1.0, t.shape))
    return xyz.astype(np.float32), inten.astype(np.float32)


def pad_frame(xyz: np.ndarray, capacity: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(capacity, 3) zero-padded xyz and its (capacity,) validity mask."""
    n = xyz.shape[0]
    if n > capacity:
        raise ValueError(f"cloud has {n} points, exceeds capacity {capacity}")
    out = np.zeros((capacity, 3), np.float32)
    out[:n] = xyz
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return out, mask
