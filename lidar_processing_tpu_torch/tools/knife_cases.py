"""Crafted cell pairs on the knife edge d² = R² for the clustering screens.

Numpy only, made from a seed, shared by the CPU tests and chip_smoke.py.

Every exact clustering of the package decides a cell pair in three steps:
the AABB gap screen (gap² > R²: "impossible"), the representative-point
screen (rep d² <= R²: "certain"), and the exact min-d² test of the pairs
that neither screen decides; the x-band path adds the halo test across a
band boundary. Each of these computes a sum of three squares in float32,
and where that sum lands within an ULP of R² its rounding decides the
verdict. Three roundings occur:

- ``unfused``: (x² + y²) + z², each product and sum rounded on its own;
- ``fma_yx``: fma(z, z, fma(y, y, x·x)), what XLA's CPU compile of
  ``jnp.sum(v * v, axis)`` over three components computes;
- ``fma_xy``: fma(z, z, fma(x, x, y·y)).

``knife_cloud`` builds one cloud of many cases. A case is two sides A
and B of four or more points each (so either side alone is a cluster of
``min_cluster_size`` 4), placed as a ``design`` (``DESIGNS``) in an
``orient``:

- design ``gap``: A's top corner and B's bottom corner are the nearest
  pair and span the AABB gap exactly, the representative points (each
  cell's first point) are far apart. The pair links iff the gap screen
  and the exact test both put the corner triple at or under R².
- design ``rep``: the AABBs overlap in two axes (gap² well under R²), the
  representative points are the nearest pair. The pair links iff the rep
  screen or the exact test puts the rep triple at or under R².
- design ``exact``: ``rep``'s points with far ones first, so the screens
  decide nothing and the exact test alone decides.
- designs ``gap2``, ``rep2``, ``exact2``: the same two cells apart in one
  column, a middle cell linked to B alone (the k = 2 intra-column pair).
- designs ``probe13``, ``probe24``, ``probe12``, ``probe34``: A one cell,
  B a two-cell supernode; the knife pair is the one of the four supernode
  rep probes the name gives.
- orient ``column``: B on top of A in one xy column (the stixel path's
  intra-column cell screens; the cellgraph's neighbour screens);
  ``row``: B in the next x column, same z cell (the stixel supernode
  screens); ``band``: as ``row``, with A and B on either side of the
  boundary of 2 x-bands (the band path's halo test; the single-device
  supernode screens).

Each case's triple (the knife pair's float32 coordinate differences) is
searched so that the three roundings give the verdicts its ``cls`` asks
for, (unfused, fma_yx, fma_xy) <= R². The cloud's two anchors pin the
cells' grid origin and the bands' range (x in [-10, 10]).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import dataclasses

import numpy as np

from ..config import DEFAULT_CONFIG

R2 = np.float32(0.18)
H = math.sqrt(0.18 / 3.0)        # the cell side of both clusterings
_F32 = np.float32


def d2_unfused(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, _F32)
    x, y, z = t[..., 0], t[..., 1], t[..., 2]
    return (x * x + y * y) + z * z


def _fma(a, b, c):
    ld = np.longdouble
    return (ld(a) * ld(b) + ld(c)).astype(_F32)


def d2_fma_yx(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, _F32)
    x, y, z = t[..., 0], t[..., 1], t[..., 2]
    return _fma(z, z, _fma(y, y, x * x))


def d2_fma_xy(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, _F32)
    x, y, z = t[..., 0], t[..., 1], t[..., 2]
    return _fma(z, z, _fma(x, x, y * y))


ROUNDINGS = {"unfused": d2_unfused, "fma_yx": d2_fma_yx,
             "fma_xy": d2_fma_xy}


def verdicts(t) -> Tuple[bool, bool, bool]:
    """(unfused, fma_yx, fma_xy) d² <= R² for one triple."""
    return tuple(bool(f(t) <= R2) for f in ROUNDINGS.values())


# Designs in local (a, b, s) coordinates, in cell sides: s is the stacking
# axis. Each is (side A, side B, knife): every cell's first point listed
# first (its representative), the knife pair (A row, B row), and B's
# knife point only approximate: the search moves it onto the knife.
_GAP = (((0.01, 0.01, 0.01), (0.02, 0.02, 0.30), (0.03, 0.04, 0.50),
         (0.05, 0.05, 0.60)),
        ((0.95, 0.95, 1.99), (0.85, 0.85, 1.91), (0.90, 0.92, 1.95),
         (0.93, 0.90, 1.97)), (3, 1))
_REP = (((0.02, 0.02, 0.50), (0.95, 0.02, 0.02), (0.02, 0.95, 0.02),
         (0.01, 0.01, 0.01)),
        ((0.82, 0.82, 1.81), (0.90, 0.90, 1.95), (0.95, 0.95, 1.99),
         (0.88, 0.93, 1.97)), (0, 0))
_EXACT = ((_REP[0][3],) + _REP[0][:3],
          (_REP[1][2], _REP[1][0], _REP[1][1], _REP[1][3]), (1, 1))
# two cells apart in one column (s in [0, 1) and [2, 3)), the middle cell
# W (B's last two rows) linked to B only: the k = 2 intra-column pair
_W = ((0.95, 0.95, 1.95), (0.90, 0.95, 1.90))
_GAP2 = (((0.01, 0.01, 0.01), (0.02, 0.02, 0.10), (0.03, 0.04, 0.20),
          (0.05, 0.05, 0.35)),
         ((0.95, 0.95, 2.95), (0.35, 0.35, 2.03), (0.60, 0.70, 2.50),
          (0.70, 0.60, 2.60)) + _W, (3, 1))
_REP2 = (((0.02, 0.02, 0.35), (0.95, 0.02, 0.02), (0.02, 0.95, 0.02),
          (0.01, 0.01, 0.01)),
         ((0.32, 0.32, 2.03), (0.60, 0.70, 2.50), (0.70, 0.60, 2.60),
          (0.95, 0.95, 2.95)) + _W, (0, 0))
_EXACT2 = ((_REP2[0][3],) + _REP2[0][:3],
           (_REP2[1][3],) + _REP2[1][:3] + _W, (1, 1))
# supernode probes (orient "row": s = x, a = y, b = z): A one cell, B two
# cells of one column (b in [0, 1) and [1, 2)), linked into one supernode;
# the knife pair is A's rep and B's bottom-cell rep (probes 1 and 3 of the
# four rep-pair probes). Reflections move it to the top cell (b -> 2 - b:
# probes 2 and 4) and swap the columns (s -> 2 - s: probes 1, 2 or 3, 4).
_PROBE = (((0.05, 0.05, 0.30), (0.01, 0.01, 0.01), (0.02, 0.03, 0.10),
           (0.04, 0.02, 0.20)),
          ((0.90, 0.45, 1.75), (0.95, 0.50, 1.80), (0.95, 1.95, 1.02),
           (0.05, 1.95, 1.95), (0.90, 1.05, 1.75)), (0, 0))


def _reflect(design, axis):
    flip = lambda p: tuple(2.0 - c if i == axis else c  # noqa: E731
                           for i, c in enumerate(p))
    a, b, knife = design
    return tuple(flip(p) for p in a), tuple(flip(p) for p in b), knife


DESIGNS = {"gap": _GAP, "rep": _REP, "exact": _EXACT, "gap2": _GAP2,
           "rep2": _REP2, "exact2": _EXACT2, "probe13": _PROBE,
           "probe24": _reflect(_PROBE, 1),
           "probe12": _reflect(_PROBE, 2),
           "probe34": _reflect(_reflect(_PROBE, 1), 2)}
ORIENTS = ("column", "row", "band")


class Case(NamedTuple):
    design: str                  # a key of DESIGNS
    orient: str                  # one of ORIENTS
    cls: Tuple[bool, bool, bool]
    a: np.ndarray                # side A's rows of the cloud
    b: np.ndarray                # side B's rows
    triple: np.ndarray           # (3,) f32 |knife pair difference|


def _to_xyz(orient: str, local) -> np.ndarray:
    local = np.asarray(local, np.float64)
    return local if orient == "column" else local[..., [2, 0, 1]]


def _cells(p: np.ndarray, origin: np.ndarray) -> np.ndarray:
    """Cell coordinates of f32 points under both clusterings' grids
    (stixel multiplies by 1/h, the cellgraph divides by h); they must
    agree for a crafted case to mean one thing."""
    rel = (p - origin).astype(_F32)
    a = np.floor(rel * _F32(1.0 / H)).astype(np.int64)
    b = np.floor(rel / _F32(H)).astype(np.int64)
    assert (a == b).all(), "a crafted point sits on a cell boundary"
    return a


def _search(rng, p, d0, orient, cls, batches: int = 1024, draws: int = 256):
    """B's knife point q = p + d·h, d near d0 (local), whose |q - p|
    triple has the verdicts `cls`: batches of `draws` jittered (a, b),
    s solved onto the sphere, each with the 97 float32 neighbours of s."""
    axis = 2 if orient == "column" else 0
    steps = np.arange(-48, 49).astype(_F32)
    r2 = float(R2) / (H * H)
    for _ in range(batches):
        dab = d0[:2] + rng.uniform(-0.01, 0.01, (draws, 2))
        ds = np.sign(d0[2]) * np.sqrt(r2 - (dab * dab).sum(1))
        q = (p + _to_xyz(orient, np.concatenate([dab, ds[:, None]], 1)) * H
             ).astype(_F32)                                    # (D, 3)
        qk = np.repeat(q[:, None], len(steps), 1)              # (D, K, 3)
        qk[..., axis] = q[:, axis, None] + steps * np.spacing(
            q[:, axis, None])
        t = np.abs(qk - p).astype(_F32).reshape(-1, 3)
        hit = np.ones(len(t), bool)
        for f, want in zip(ROUNDINGS.values(), cls):
            hit &= (f(t) <= R2) == want
        if hit.any():
            k = int(np.flatnonzero(hit)[rng.integers(hit.sum())])
            return qk.reshape(-1, 3)[k], t[k]
    raise ValueError(f"no triple of class {cls} found")


def knife_cloud(specs: Sequence[Tuple[str, str, Tuple[bool, bool, bool]]],
                seed: int = 0) -> Tuple[np.ndarray, List[Case]]:
    """(xyz (N, 3) f32, cases): two anchors, then each case's side A and
    side B rows, in `specs` order (design, orient, cls)."""
    rng = np.random.default_rng(seed)
    origin = np.array([-10.0, 0.0, 0.0], _F32)
    rows = [origin, np.array([10.0, 0.0, 0.0], _F32)]
    cases = []
    # the 2-band boundary x_lo + (x_hi - x_lo) / 2 * (1 + 1e-6); a "band"
    # case's x cell puts side A left of it and side B right of it
    boundary = -10.0 + 10.0 * (1 + 1e-6)
    x_band = math.floor(10.0 / H - 0.6)
    for j, (design, orient, cls) in enumerate(specs):
        side_a, side_b, (ka, kb) = DESIGNS[design]
        corner = np.array([x_band if orient == "band" else 25, 8 + 10 * j, 4])

        def place(local):
            return (origin + (corner + _to_xyz(orient, local)) * H
                    ).astype(_F32)

        a = [place(p) for p in side_a]
        b = [place(p) for p in side_b]
        d0 = np.subtract(side_b[kb], side_a[ka])
        b[kb], t = _search(rng, a[ka], d0, orient, cls)
        want = corner + np.floor(_to_xyz(orient, side_a + side_b))
        assert (_cells(np.stack(a + b), origin) == want).all(), design
        if orient == "band":
            assert max(p[0] for p in a) < boundary < min(p[0] for p in b)
        base = len(rows)
        rows += a + b
        cases.append(Case(design, orient, tuple(cls),
                          np.arange(base, base + len(a)),
                          np.arange(base + len(a), len(rows)), t))
    xyz = np.stack(rows).astype(_F32)
    _check_isolated(xyz, cases)
    return xyz, cases


def _check_isolated(xyz: np.ndarray, cases: List[Case]) -> None:
    """Across a case's two sides only the knife pair is near R²; no point
    of one case is within 2R of another case's."""
    x64 = xyz.astype(np.float64)
    for c in cases:
        d2 = ((x64[c.a][:, None] - x64[c.b][None]) ** 2).sum(-1)
        near = np.sort(d2.ravel())
        assert near[0] < 0.1801 and near[1] > 0.18 * 1.05, (c, near[:2])
    owner = np.full(len(xyz), -1)
    for i, c in enumerate(cases):
        owner[c.a] = owner[c.b] = i
    d2 = ((x64[:, None] - x64[None]) ** 2).sum(-1)
    assert (d2[owner[:, None] != owner[None, :]] > 4 * 0.18).all()


def linked(labels: np.ndarray, case: Case) -> bool:
    """Whether a case's two sides came out as one cluster; each side must
    be one cluster (labels >= 0)."""
    la, lb = labels[case.a], labels[case.b]
    assert (la >= 0).all() and (lb >= 0).all(), (case.design, la, lb)
    assert len(set(la)) == 1 and len(set(lb)) == 1, (case.design, la, lb)
    return bool(la[0] == lb[0])


# One crafted case per screen, each of a class on which the old unfused
# port and the JAX package part: (design, orient, class).
_T, _F = True, False
SCREENS = {
    "cell_gap": ("gap", "column", (_T, _F, _F)),
    "cell_gap_k2": ("gap2", "column", (_T, _F, _F)),
    "cell_rep": ("rep", "column", (_F, _T, _F)),
    "cell_rep_k2": ("rep2", "column", (_F, _T, _F)),
    "sn_gap": ("gap", "row", (_T, _F, _F)),
    "sn_rep_13": ("probe13", "row", (_F, _T, _F)),
    "sn_rep_24": ("probe24", "row", (_F, _T, _F)),
    "sn_rep_12": ("probe12", "row", (_F, _T, _F)),
    "sn_rep_34": ("probe34", "row", (_F, _T, _F)),
    "exact_cells": ("exact", "column", (_F, _F, _T)),
    "exact_sn": ("exact", "row", (_F, _F, _T)),
    "exact_cellgraph": ("exact", "column", (_T, _F, _T)),
    "halo_gap": ("gap", "band", (_T, _F, _F)),
    "halo_rep": ("rep", "band", (_F, _T, _F)),
    "halo_split": ("gap", "band", (_T, _T, _F)),
}
PATHS = ("stixel", "cellgraph", "bands")

# What the JAX package's jitted functions on the CPU decide, per screen and
# path (stixel ``cluster``, cellgraph ``cluster``, ``cluster_spatial`` at 2
# bands) under PIPELINE / SPATIAL (and at 8 bands under block_cells 4096).
# Its roundings there: every screen, the
# cellgraph's exact row scan and the halo test fma_yx; the stixel exact
# test fma_xy; the k = 1 cell rep screen fma_yx at max_cells 20480 but
# unfused at the bands' block_cells 16384 (XLA fuses by shape).
JAX_LINKED = {
    "cell_gap": (_F, _F, _F), "cell_gap_k2": (_F, _F, _F),
    "cell_rep": (_T, _T, _F), "cell_rep_k2": (_T, _T, _T),
    "sn_gap": (_F, _F, _F), "sn_rep_13": (_T, _T, _T),
    "sn_rep_24": (_T, _T, _T), "sn_rep_12": (_T, _T, _T),
    "sn_rep_34": (_T, _T, _T), "exact_cells": (_T, _F, _T),
    "exact_sn": (_T, _F, _T), "exact_cellgraph": (_T, _F, _T),
    "halo_gap": (_F, _F, _F), "halo_rep": (_T, _T, _T),
    "halo_split": (_F, _T, _T)}
# The port's: one rounding a screen whatever the caps, so the bands'
# cell_rep links as the single-device path does.
PORT_LINKED = dict(JAX_LINKED, cell_rep=(_T, _T, _T))

# The caps the crafted clouds run under: the shipped ones (the JAX
# package's k = 1 cell rep screen rounds by max_cells), the padded cloud
# cut to 8192 points.
PIPELINE = dataclasses.replace(DEFAULT_CONFIG.pipeline, max_points=8192)
SPATIAL = DEFAULT_CONFIG.spatial


def screen_cloud(seed: int = 0):
    """(xyz (N, 3) f32, {screen: Case}) for every screen of SCREENS."""
    xyz, cases = knife_cloud(list(SCREENS.values()), seed)
    return xyz, dict(zip(SCREENS, cases))


# tests/test_torch_spatial.py's KNIFE rows: (x of A, x of B, z of B); A =
# (xa, y, 0) and B = (xb, y, zb) straddle the boundary of 2 bands, dy = 0,
# so both fused roundings agree. Their d² is one ULP under R² = 0.18f,
# equal to it, one ULP over it, and equal to it unfused where a fused
# multiply-add of dz² rounds one ULP over.
KNIFE = ((-0.2, 0.22426403, 0.00021114), (-0.2, 0.22426403, 0.00024385),
         (-0.2, 0.22426403, 0.00027238), (-0.1, 0.20210448, 0.29788068))


def knife_rows() -> np.ndarray:
    """The KNIFE cloud: per row, A chained to 3 more points on its side
    and B to 3 on its own (clusters of 4 either side), 5 m apart in y;
    then chains of 4 at x = -10 and x = 10 that pin the bands' range."""
    f32 = np.float32
    rows = []
    for row, (xa, xb, zb) in enumerate(KNIFE):
        y = 5.0 * row
        rows += [[f32(xa) - f32(0.1 * k), y, 0.0] for k in range(4)]
        rows += [[f32(xb) + f32(0.1 * k), y, zb] for k in range(4)]
    rows += [[-10.0 + 0.1 * k, 30.0, 0.0] for k in range(4)]
    rows += [[10.0 - 0.1 * k, 30.0, 0.0] for k in range(4)]
    return np.asarray(rows, f32)


def knife_linked(labels: np.ndarray):
    """Per KNIFE row, whether A's and B's chains came out as one."""
    out = []
    for row in range(len(KNIFE)):
        ends = labels[row * 8:row * 8 + 8]
        assert (ends >= 0).all(), (row, ends)
        out.append(len(set(ends.tolist())) == 1)
    return tuple(out)
