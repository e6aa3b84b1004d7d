"""The benchmark's scene generator against the port's, and its files."""

import numpy as np
import pytest

from lidarbench import scenes


@pytest.mark.parametrize("seed", [0, 5])
def test_hdl64e_row_reproduces_the_port_generator(spec, seed):
    from lidar_processing_tpu_torch.io.synthetic import street_scene
    xyz, inten = scenes.street_sweep(seed, spec.config("kitti-hdl64e"))
    ref_xyz, ref_inten = street_scene(seed, "full")
    assert xyz.dtype == np.float32 and xyz.shape == ref_xyz.shape
    np.testing.assert_array_equal(xyz, ref_xyz)
    np.testing.assert_array_equal(inten, ref_inten)


def test_hdl32e_sweep_matches_its_sensor(spec):
    cfg = spec.config("nuscenes-hdl32e")
    el = scenes.elevations_deg(cfg["sensor"])
    assert el.shape == (32,) and el[0] == 10.67 and el[-1] == -30.67
    xyz, _ = scenes.street_sweep(3, cfg)
    assert 20000 < xyz.shape[0] <= 32 * 1084
    assert xyz.shape[0] <= cfg["engine"]["pipeline"]["max_points"]
    r = np.hypot(xyz[:, 0], xyz[:, 1])
    assert r.max() < 70.5
    # road points lie about the sensor's height below it
    assert abs(np.median(xyz[xyz[:, 2] < -1.7, 2]) + 1.84) < 0.05


def test_resident_frames_reorder_the_same_streets(spec):
    from lidarbench.tests.small import small_config
    cfg = small_config()
    big = 2 ** 31 + 987654321
    a = scenes.resident_frames(cfg, big, 5)
    b = scenes.resident_frames(cfg, big, 5)
    c = scenes.resident_frames(cfg, big + 1, 5)
    for (xa, ia), (xb, ib) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ia, ib)
    streets = [scenes.street_sweep(k, cfg)[0] for k in range(5)]
    for run in (a, c):
        order = [next(k for k, s in enumerate(streets)
                      if s.shape == x.shape and np.array_equal(s, x))
                 for x, _ in run]
        assert sorted(order) == list(range(5))
    assert any(x.shape != y.shape or not np.array_equal(x, y)
               for (x, _), (y, _) in zip(a, c))


def test_pcd_files_read_back_exactly(tmp_path, spec):
    from lidar_processing_tpu_torch.io.pcd import read_pcd_xyzi
    from lidarbench.tests.small import small_config
    xyz, inten = scenes.street_sweep(1, small_config())
    path = tmp_path / "000000.pcd"
    scenes.write_pcd(str(path), xyz, inten)
    rx, ri = read_pcd_xyzi(str(path))
    np.testing.assert_array_equal(rx, xyz)
    np.testing.assert_array_equal(ri, inten)
