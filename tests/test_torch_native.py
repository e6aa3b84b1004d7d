"""PyTorch port: the native C++ host module (ops/hull_native.py, built by
native/_build.py) against the JAX package's oracles, at the tolerances of
tests/test_native.py, and against the JAX package's own native module.

The JAX package builds its library only out of band (native/Makefile), so
``jax_native`` compiles the JAX source with the Makefile's flags into a
temporary directory and points the JAX loader at it for one test; both
packages then run the same C++ on the same inputs. Other test files import
the two fixtures from here.
"""

import re
import subprocess
from pathlib import Path

import numpy as np
import pytest

import lidar_processing_tpu
from lidar_processing_tpu.config import ClusteringConfig
from lidar_processing_tpu.ops import hull_native as jnative
from lidar_processing_tpu.oracle import reference as orc
from lidar_processing_tpu.oracle.diff import polygon_chamfer
from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
from lidar_processing_tpu_torch.native import _build
from lidar_processing_tpu_torch.ops import host_hulls
from lidar_processing_tpu_torch.ops import hull_native as tn
from lidar_processing_tpu_torch.runtime import pipeline as tpipe

_JAX_NATIVE = Path(lidar_processing_tpu.__file__).resolve().parent / "native"


@pytest.fixture(scope="session")
def jax_native_lib(tmp_path_factory):
    """The JAX package's lidar_native.cpp built with its Makefile's flags
    outside its tree: <root>/native/liblidar_native.so. Each module that
    imports this fixture gets its own copy of it, so the library is kept
    in the session's base temp directory and built once per process."""
    root = tmp_path_factory.getbasetemp() / "jax_native"
    lib = root / "native" / "liblidar_native.so"
    if lib.exists():
        return root
    flags = re.search(r"^CXXFLAGS \?= (.*)$",
                      (_JAX_NATIVE / "Makefile").read_text(), re.M)
    lib.parent.mkdir(parents=True)
    subprocess.run(["g++", *flags.group(1).split(), "-o", str(lib),
                    str(_JAX_NATIVE / "lidar_native.cpp")],
                   check=True, capture_output=True)
    return root


@pytest.fixture
def jax_native(jax_native_lib, monkeypatch):
    """The JAX hull_native module, loading the library built above for the
    length of one test (monkeypatch restores its __file__ and cache)."""
    monkeypatch.setattr(jnative, "__file__",
                        str(jax_native_lib / "ops" / "hull_native.py"))
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_LIB_TRIED", False)
    assert jnative.native_available()
    return jnative


def _ccw(pts, idx):
    x, y = pts[idx, 0], pts[idx, 1]
    return np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) > 0


def test_source_is_the_jax_packages():
    assert (Path(_build.SOURCE).read_bytes()
            == (_JAX_NATIVE / "lidar_native.cpp").read_bytes())
    assert tn.native_available()


def test_convex_matches_oracle():
    rng = np.random.default_rng(0)
    for _ in range(20):
        pts = rng.normal(0, 2, (rng.integers(3, 200), 2)).astype(np.float32)
        nat = tn.convex_hull_indices(pts)
        assert set(nat.tolist()) == set(orc.convex_hull_indices(pts).tolist())
        assert _ccw(pts, nat)
    collinear = np.array([[0, 0], [1, 1], [2, 2], [3, 3]], np.float32)
    assert set(tn.convex_hull_indices(collinear).tolist()) == {0, 3}
    assert tn.convex_hull_indices(np.zeros((0, 2), np.float32)).shape == (0,)


@pytest.mark.parametrize("n", [3, 17, 300, 1500, 5000])
def test_chan_matches_monotone(n):
    pts = np.random.default_rng(n).normal(0, 5, (n, 2)).astype(np.float32)
    chan = tn.convex_hull_indices(pts, algorithm="chan")
    mono = tn.convex_hull_indices(pts, algorithm="monotone")
    assert set(chan.tolist()) == set(mono.tolist())
    assert _ccw(pts, chan)


def test_chan_adversarial():
    rng = np.random.default_rng(1)
    g = np.stack(np.meshgrid(np.arange(40), np.arange(40)),
                 -1).reshape(-1, 2).astype(np.float32)
    dup = np.repeat(rng.normal(0, 1, (50, 2)), 30, axis=0).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, 2000)
    circ = np.stack([np.cos(th), np.sin(th)], 1).astype(np.float32)
    for pts in (g, dup, circ, np.zeros((1, 2), np.float32),
                np.array([[0, 0], [1, 0]], np.float32)):
        pts = pts[rng.permutation(len(pts))]
        chan = tn.convex_hull_indices(pts, algorithm="chan")
        mono = tn.convex_hull_indices(pts, algorithm="monotone")
        assert (set(map(tuple, pts[chan].tolist()))
                == set(map(tuple, pts[mono].tolist())))


def test_chi_matches_scipy_oracle():
    rng = np.random.default_rng(2)
    worst = 0.0
    for _ in range(15):
        pts = rng.normal(0, 2, (int(rng.integers(25, 400)), 2)).astype(
            np.float32)
        ref = pts[orc.chi_concave_hull_indices(pts, 0.2)]
        worst = max(worst, polygon_chamfer(tn.chi_concave_hull(pts, 0.2),
                                           ref))
    assert worst < 0.05, worst
    pts = rng.normal(0, 2, (100, 2)).astype(np.float32)
    assert polygon_chamfer(tn.chi_concave_hull(pts, 1.0),
                           pts[orc.convex_hull_indices(pts)]) < 1e-5


def test_chi_degenerate_inputs_take_the_oracle_chain():
    """A collinear set (the native call refuses it) and fewer than 3
    points go to the scipy chain, as in the JAX package."""
    for pts in (np.array([[0, 0], [1, 0], [2, 0], [3, 0]], np.float32),
                np.array([[0, 0], [1, 2]], np.float32),
                np.zeros((0, 2), np.float32)):
        got = tn.chi_concave_hull(pts, 0.2)
        np.testing.assert_array_equal(got, host_hulls.chi_concave_hull(pts,
                                                                       0.2))
        np.testing.assert_array_equal(got, jnative.chi_concave_hull(pts, 0.2))
    assert tn.chi_concave_hull(np.array([[0, 0], [1, 0], [2, 0], [3, 0]],
                                        np.float32), 0.2).shape[0] >= 2


def _clusters(seed):
    """Cluster point sets as the host stage sees them: blobs of many
    sizes, with a collinear run, a 2-point and an empty cluster."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(c, s, (int(k), 2)).astype(np.float32) for c, s, k in
           zip(rng.uniform(-30, 30, 40), rng.uniform(0.2, 3.0, 40),
               rng.integers(3, 900, 40))]
    out[5] = np.stack([np.arange(40), 2 * np.arange(40) + 1],
                      1).astype(np.float32)
    out[9] = out[9][:2]
    out[13] = out[13][:0]
    return out


def _packed(clusters):
    offs = np.zeros(len(clusters) + 1, np.int64)
    np.cumsum([len(c) for c in clusters], out=offs[1:])
    return np.concatenate(clusters), offs


def test_chi_hulls_batch_equals_single_calls():
    clusters = _clusters(3)
    packed, offs = _packed(clusters)
    calls, falls = tn.chi_hulls_batch.calls, tn.chi_hulls_batch.fallbacks
    got = tn.chi_hulls_batch(packed, offs, 0.1)
    assert tn.chi_hulls_batch.calls == calls + 1
    assert tn.chi_hulls_batch.fallbacks == falls + 3   # collinear, 2, empty
    assert len(got) == len(clusters)
    for g, c in zip(got, clusters):
        want = tn.chi_concave_hull(c, 0.1)
        assert g.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(g, want)
    assert tn.chi_hulls_batch(packed[:0], offs[:1], 0.1) == []


def test_fec_matches_python_oracle():
    cfg = ClusteringConfig()
    pts = np.random.default_rng(4).normal(0, 1.0, (3000, 3)).astype(
        np.float32)
    nat = tn.fec_cluster(pts, cfg.distance_squared, cfg.cluster_quality,
                         cfg.min_cluster_size, cfg.max_cluster_size)
    np.testing.assert_array_equal(nat, orc.fec_cluster(pts, cfg,
                                                       allow_native=False))


def test_union_find_matches_jax_scipy_path():
    assert not jnative.native_available()      # the scipy path
    rng = np.random.default_rng(5)
    for n, e in ((500, 800), (2000, 1500), (10, 0)):
        u = rng.integers(0, n, e).astype(np.int32)
        v = rng.integers(0, n, e).astype(np.int32)
        got = tn.union_find_cc(u, v, n)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jnative.union_find_cc(u, v, n))


def test_unchecked_native_indices_are_validated_first():
    """Inputs the C code would index out of bounds raise in Python."""
    u = np.array([0, 1], np.int32)
    for bad_u, bad_v in ((u, u[:1]), (u, np.array([0, 5], np.int32)),
                         (np.array([-1, 0], np.int32), u)):
        with pytest.raises(ValueError, match="union_find_cc"):
            tn.union_find_cc(bad_u, bad_v, 5)
    packed, offs = _packed(_clusters(3)[:4])
    for bad in (offs + 1, offs[::-1].copy(), np.r_[offs[:-1], offs[-1] + 1]):
        with pytest.raises(ValueError, match="chi_hulls_batch"):
            tn.chi_hulls_batch(packed, bad, 0.1)


def test_radius_cc_vs_bruteforce():
    n, r = 400, 0.8
    pts = np.random.default_rng(6).uniform(-3, 3, (n, 3)).astype(np.float32)
    adj = np.sum((pts[:, None] - pts[None, :]) ** 2, -1) <= r * r
    ref = np.arange(n)
    for _ in range(n):
        new = np.minimum(ref, np.min(np.where(adj, ref[None, :], n), axis=1))
        new = new[new]
        if np.array_equal(new, ref):
            break
        ref = new
    np.testing.assert_array_equal(tn.radius_cc(pts, r), ref)
    assert tn.radius_cc(pts[:0], r).shape == (0,)


def test_same_results_as_the_jax_native_module(jax_native):
    """Both packages' libraries (one source) agree call for call."""
    clusters = _clusters(7)
    packed, offs = _packed(clusters)
    for g, w in zip(tn.chi_hulls_batch(packed, offs, 0.1),
                    jax_native.chi_hulls_batch(packed, offs, 0.1)):
        np.testing.assert_array_equal(g, w)
    for c in clusters:
        for algo in ("monotone", "chan"):
            np.testing.assert_array_equal(
                tn.convex_hull_indices(c, algo),
                jax_native.convex_hull_indices(c, algo))
    pts = np.random.default_rng(8).normal(0, 2, (2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tn.radius_cc(pts, 0.4),
                                  jax_native.radius_cc(pts, 0.4))


def test_library_name_hashes_the_host_cpu(monkeypatch):
    """A library built on another CPU (-march=native) gets another name,
    so a build directory copied between machines is never reused."""
    cxx = _build._cxx()
    here = _build._digest(cxx)
    assert "march=" in _build.host_target(cxx)
    monkeypatch.setattr(_build, "host_target", lambda cxx: "another cpu")
    assert _build._digest(cxx) != here


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """The native build pointed at a source g++ refuses."""
    src = tmp_path / "lidar_native.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(_build, "SOURCE", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.build.cache_clear()
    _build.library.cache_clear()
    yield
    _build.build.cache_clear()
    _build.library.cache_clear()


def test_broken_build_raises_and_never_reaches_scipy(broken_build,
                                                     monkeypatch):
    def scipy_chain(*args):
        raise AssertionError("the host stage fell back to scipy")
    monkeypatch.setattr(tn, "_oracle_chain", scipy_chain)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tn.native_available()
    slices = _clusters(9)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        tpipe._outlines_from_slices(slices, DEFAULT_CONFIG)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tn.chi_concave_hull(slices[0], 0.1)


def test_missing_entry_point_raises(tmp_path, monkeypatch):
    lib = tmp_path / "liblidar_native_stale.so"
    src = tmp_path / "stale.cpp"
    src.write_text('extern "C" int convex_hull() { return 0; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    monkeypatch.setattr(_build, "build",
                        lambda: _build.BuildInfo(lib, "", 0.0))
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no entry point"):
            _build.library()
    finally:
        _build.library.cache_clear()
