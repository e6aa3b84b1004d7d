"""PyTorch port on the card: CUDA kernels and the CUDA path vs the twins.

Every test here needs an NVIDIA GPU (marked `cuda`) and skips without
one. The file imports no jax, so it also runs on a machine without jax:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.kernels import union_find as tuf
from lidar_processing_tpu_torch.kernels.min_d2 import (min_d2_planar,
                                                       min_d2_planar_ref)
from lidar_processing_tpu_torch.ops import stixel as tsx
from lidar_processing_tpu_torch.ops.segmentation import gpf_segment_sorted
from lidar_processing_tpu_torch.runtime.pipeline import (
    device_frame_step_packed)
from lidar_processing_tpu_torch.types import SEG_OBSTACLE

pytestmark = pytest.mark.cuda

CAP = 4096
CFG = DEFAULT_CONFIG.replace(pipeline=dataclasses.replace(
    DEFAULT_CONFIG.pipeline, max_points=CAP, max_obstacle_points=CAP,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _ulp(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def test_min_d2_kernel_matches_twin_at_tier_shapes(cuda):
    rng = np.random.default_rng(0)
    for u_cap, v_cap, slots in tsx._TIERS_INTRA + tsx._TIERS_SNP:
        wu, wv = u_cap + 8, v_cap + 32
        planes = [rng.uniform(-30, 30, (slots, w)).astype(np.float32)
                  for w in (wu, wu, wu, wv, wv, wv)]
        for a in planes[:3]:
            a[::5, wu // 2:] = 1.0e9
        for a in planes[3:]:
            a[::3, wv // 3:] = -1.0e9
        args = [torch.from_numpy(a).to(cuda) for a in planes]
        before = min_d2_planar.launches
        got = min_d2_planar(*args).cpu().numpy()
        assert min_d2_planar.launches == before + 1
        assert _ulp(got, min_d2_planar_ref(*args).cpu().numpy()) <= 4


def test_union_find_kernel_matches_twin(cuda):
    rng = np.random.default_rng(1)
    for s_cap, n_edges in ((128, 0), (2048, 4000), (10240, 32000)):
        eu = rng.integers(0, s_cap, 32768).astype(np.int32)
        ev = np.minimum(s_cap - 1, eu + rng.integers(1, 30, 32768)
                        ).astype(np.int32)
        eu, ev = torch.from_numpy(eu).to(cuda), torch.from_numpy(ev).to(cuda)
        ne = torch.tensor(n_edges, dtype=torch.int32, device=cuda)
        got = tuf.cc_labels(eu, ev, ne, s_cap).cpu().numpy()
        np.testing.assert_array_equal(
            got, tuf.cc_labels_ref(eu, ev, ne, s_cap).cpu().numpy())


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    good = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError):
        min_d2_planar(good, good, good.double(), good, good, good)
    with pytest.raises(ValueError):
        min_d2_planar(good, good, good, good, good, good.t())
    e = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tuf.cc_labels(e, e, e[:1].reshape(()), 60000)


@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_path_matches_cpu_path(cuda, seed):
    """cluster_fused on the card (kernels) == on the CPU (twins) from the
    same sorted inputs; the packed payload too where segmentation agrees."""
    xyz, _ = street_scene(seed, "small")
    x, m = (torch.from_numpy(a) for a in pad_frame(xyz, CAP))
    ss = gpf_segment_sorted(x.to(cuda), m.to(cuda), CFG.segmentation)
    args = (ss.xyz, ss.valid & (ss.labels == SEG_OBSTACLE), ss.valid,
            ss.orig, ss.labels)
    on_gpu = tsx.cluster_fused(*args, CFG.clustering, CFG.pipeline)
    on_cpu = tsx.cluster_fused(*(a.cpu() for a in args), CFG.clustering,
                               CFG.pipeline)
    for g, c in zip((*on_gpu.result, *on_gpu[1:]),
                    (*on_cpu.result, *on_cpu[1:])):
        assert g.dtype == c.dtype and torch.equal(g.cpu(), c)
    pay_gpu = device_frame_step_packed(x.to(cuda), m.to(cuda), CFG).cpu()
    pay_cpu = device_frame_step_packed(x, m, CFG)
    assert torch.equal(pay_gpu, pay_cpu)
