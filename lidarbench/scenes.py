"""Seeded street scenes seen by a configured spinning LiDAR.

The benchmark's own scene generator: a copy of the port's
``io/synthetic.py`` ray caster with the sensor taken from a
configuration file instead of fixed. The sensor is a list of elevation
blocks (beams spaced evenly from a top to a bottom angle), a number of
azimuth steps a revolution, a maximum range and a mounting height above
a flat road. The street (cars in lanes and at the kerbs, pedestrians,
poles, bollards, bushes, clutter, building facades) is the original's
``"full"`` street. With the HDL-64E row (two blocks of 32 beams, 1900
azimuth steps, 80 m, 1.73 m) it reproduces ``street_scene(seed, "full")``
bit for bit: every random draw is made in the same order with the same
shapes, and every expression is the original's.

Every ray returns the nearest hit among the road and the scene's
objects, so points lie on surfaces, density falls off with range and
objects occlude what lies behind them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _boxes(rng, n, x_range, y_choices, size_lo, size_hi, yaw_sd, ground_z,
           z_bottom=0.0):
    """n boxes: centers (n,3), half sizes (n,3), yaw (n,)."""
    size = rng.uniform(size_lo, size_hi, (n, 3))
    cx = rng.uniform(*x_range, n)
    cy = rng.choice(y_choices, n) + rng.normal(0.0, 0.3, n)
    cz = ground_z + z_bottom + size[:, 2] / 2
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


def _scene(rng, street: Dict, ground_z: float):
    half_len = street["half_length_m"]
    n_car, n_ped, n_pole = street["cars"], street["pedestrians"], \
        street["poles"]
    n_bush, n_clutter, n_facade = street["bushes"], street["clutter"], \
        street["facade_segments"]
    scale = half_len / 70.0
    boxes = []
    cars = _boxes(rng, n_car, (-half_len, half_len),
                  np.array([-7.0, -3.5, 0.0, 3.5]) * max(scale, 0.5),
                  (3.9, 1.6, 1.4), (4.8, 1.9, 1.6), 0.08, ground_z,
                  z_bottom=0.15)
    boxes.append(_clear_of_sensor(cars, 10.0, 5.0))
    clutter = _boxes(rng, n_clutter, (-half_len, half_len), np.zeros(1),
                     (0.3, 0.3, 0.5), (0.8, 0.8, 1.4), 0.5, ground_z)
    clutter[0][:, 1] = _roadside_y(rng, n_clutter, scale)
    boxes.append(clutter)
    fac_c, fac_h, fac_yaw = [], [], []
    for side in (-1.0, 1.0):
        x = -half_len
        for _ in range(n_facade // 2):
            length = rng.uniform(6.0, 16.0) * max(scale, 0.4)
            gap = rng.uniform(1.0, 5.0) * max(scale, 0.4)
            height = rng.uniform(4.0, 12.0)
            y = side * rng.uniform(28.0, 34.0) * max(scale, 0.6)
            fac_c.append([x + length / 2, y, ground_z + height / 2])
            fac_h.append([length / 2, 0.25, height / 2])
            fac_yaw.append(rng.normal(0.0, 0.02))
            x += length + gap
    boxes.append((np.array(fac_c), np.array(fac_h), np.array(fac_yaw)))
    centers = np.concatenate([b[0] for b in boxes])
    halves = np.concatenate([b[1] for b in boxes])
    yaws = np.concatenate([b[2] for b in boxes])

    peds = np.stack([rng.uniform(-half_len, half_len, n_ped),
                     _roadside_y(rng, n_ped, scale),
                     rng.uniform(0.2, 0.3, n_ped),
                     np.full(n_ped, ground_z),
                     ground_z + rng.uniform(1.55, 1.9, n_ped)], 1)
    poles = np.stack([rng.uniform(-half_len, half_len, n_pole),
                      _roadside_y(rng, n_pole, scale),
                      rng.uniform(0.07, 0.15, n_pole),
                      np.full(n_pole, ground_z),
                      ground_z + rng.uniform(3.5, 8.0, n_pole)], 1)
    n_boll = 2 * n_pole
    bollards = np.stack([rng.uniform(-half_len, half_len, n_boll),
                         rng.choice([-8.0, 8.0], n_boll) * max(scale, 0.6),
                         rng.uniform(0.08, 0.15, n_boll),
                         np.full(n_boll, ground_z),
                         ground_z + rng.uniform(0.8, 1.2, n_boll)], 1)
    cyl = np.concatenate([peds, poles, bollards])

    r = rng.uniform(0.25, 0.7, n_bush)
    bush = np.stack([rng.uniform(-half_len, half_len, n_bush),
                     _roadside_y(rng, n_bush, scale),
                     ground_z + r * rng.uniform(0.7, 2.5, n_bush), r], 1)
    return (centers, halves, yaws), cyl, bush


def elevations_deg(sensor: Dict) -> np.ndarray:
    """The beams' elevations in degrees, block by block, top first."""
    return np.concatenate([np.linspace(top, bottom, count)
                           for top, bottom, count in sensor["elevation_blocks"]])


def _rays(sensor: Dict, rng) -> np.ndarray:
    n_az = sensor["azimuth_steps"]
    elev = np.deg2rad(elevations_deg(sensor))
    az = (np.arange(n_az) + rng.uniform()) * (2 * np.pi / n_az)
    el, a = np.meshgrid(elev, az, indexing="ij")
    el = el + rng.normal(0.0, sensor["elevation_jitter_rad"], el.shape)
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


def street_sweep(seed: int, config: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """One sweep of the configuration's sensor over a seeded street:
    ((n, 3) float32 xyz in the sensor frame, (n,) float32 intensity)."""
    sensor, street = config["sensor"], config["street"]
    ground_z = -sensor["height_m"]
    rng = np.random.default_rng(seed)
    boxes, cyl, sph = _scene(rng, street, ground_z)
    d = _rays(sensor, rng)
    t = np.full(d.shape[0], np.inf)
    kind = np.zeros(d.shape[0], np.int8)          # 0 ground, 1 object
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
            t_gnd = np.where(dc[:, 2] < 0, ground_z / dc[:, 2], np.inf)
        t[idx] = np.minimum(t_obj, t_gnd)
        kind[idx] = t_obj < t_gnd
    keep = t <= sensor["max_range_m"]
    d, t, kind = d[keep], t[keep], kind[keep]
    t = t + rng.normal(0.0, sensor["range_noise_m"], t.shape)
    xyz = d * t[:, None]
    ground = kind == 0
    xyz[ground, 2] = ground_z + rng.normal(0.0, sensor["road_noise_m"],
                                           int(ground.sum()))
    inten = np.where(ground, rng.uniform(0.0, 0.3, t.shape),
                     rng.uniform(0.1, 1.0, t.shape))
    return xyz.astype(np.float32), inten.astype(np.float32)


def resident_frames(config: Dict, seed: int, count: int
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """A run's resident sweeps: the streets of scene seeds 0..count-1 in
    an order drawn from the run's seed (any whole number, however large).
    Every run seed gives the same streets, so the same work: a street
    turned or mirrored makes its facades' outlines cheaper or dearer to
    make on the host (up to 3x a street, 1.4x a run of 16 when turned)."""
    rng = np.random.default_rng(np.random.SeedSequence(abs(int(seed))))
    return [street_sweep(int(k), config) for k in rng.permutation(count)]


def write_pcd(path: str, xyz: np.ndarray, intensity: np.ndarray) -> None:
    """A binary PCD v0.7 file with fields x y z intensity, FLOAT32."""
    n = xyz.shape[0]
    rec = np.empty(n, dtype=np.dtype([("x", "<f4"), ("y", "<f4"),
                                      ("z", "<f4"), ("intensity", "<f4")]))
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["intensity"] = intensity
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              "FIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
              "COUNT 1 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
