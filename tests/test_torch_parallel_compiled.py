"""PyTorch port: the parallel path and the stage-timed replay on their
compiled route (runtime/compiled.py's registry), on the CPU.

The CPU has no CUDA graphs, so these tests take test_torch_compiled.py's
seam (``eager_capture``, ``graph_route``): the capture runs the program
once into its outputs, a replay reruns it into them. Through it, on two
small street scenes at test_torch_batched.py's caps (4096 points) and
test_spatial.py's 4k x-band caps:

  * ``cluster_spatial`` at 8 and 4 shards and ``device_frame_step_spatial``
    (here) and ``cluster_spatial_2d`` on 2 x 4, ``sharded_batch_step``
    and ``sharded_pipeline_2d`` (test_torch_sharded_compiled.py) equal
    the JAX package's functions on the same numpy inputs (clusterings
    bit for bit, segmentations as test_torch_spatial.py and
    test_torch_batched.py hold them), and a second call leaves the first
    call's tensors as they were;
  * equal meshes share one registered graph, ``live_graphs()`` counts
    it, and a released graph is captured again;
  * a failed capture raises out of every entry point, and no eager body
    runs in its place;
  * CUDA's DOT print is read for node kinds and NCCL kernel nodes.

Without the seam the CPU runs every entry point eagerly and registers
nothing. The stage-timed replay's compiled stages are held against the
JAX stream in test_torch_compiled.py, which shares its JAX stream. Most
of this file's time is the JAX reference's compiles (each JAX program
once: the cases reuse one another's).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from lidar_processing_tpu.parallel import frame_spatial as jfs
from lidar_processing_tpu.parallel import sharded as jsh
from lidar_processing_tpu.parallel import spatial as jsp
from lidar_processing_tpu_torch.config import SpatialConfig
from lidar_processing_tpu_torch.interop import config_from_jax, to_numpy
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
from lidar_processing_tpu_torch.parallel import frame_spatial as fs
from lidar_processing_tpu_torch.parallel import sharded as sh
from lidar_processing_tpu_torch.parallel import spatial as sp
from lidar_processing_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                                      program_name)
from lidar_processing_tpu_torch.runtime import compiled
from lidar_processing_tpu_torch.types import SEG_OBSTACLE
from test_torch_compiled import eager_capture, graph_route  # noqa: F401
from test_torch_stream import CAP, JCFG

leaves = torch.utils._pytree.tree_leaves

SCFG = SpatialConfig(block_points=2048, block_clusters=512, halo_points=512,
                     block_cells=2048, block_columns=1024,
                     block_supernodes=1536, block_column_pairs=4096,
                     block_sn_pairs=4096, block_live_edges=1024)
JCFG_S = JCFG.replace(spatial=type(JCFG.spatial)(**dataclasses.asdict(SCFG)))
CFG = config_from_jax(JCFG_S)


@pytest.fixture(autouse=True)
def no_registered_graphs():
    """Each test starts and ends with an empty registry."""
    compiled.release_graphs()
    yield
    compiled.release_graphs()


@functools.lru_cache(maxsize=None)
def _inputs():
    """Two small street scenes padded to CAP and their obstacle masks
    (the port's gpf_segment), as numpy."""
    xs, ms = (np.stack(a) for a in zip(*(
        pad_frame(street_scene(s, "small")[0], CAP) for s in (0, 1))))
    seg = gpf_segment(torch.from_numpy(xs), torch.from_numpy(ms),
                      CFG.segmentation)
    return xs, ms, (ms & (seg.labels == SEG_OBSTACLE).numpy())


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _cl(cfg):
    return cfg.clustering, cfg.pipeline, cfg.spatial


def _calls():
    """{case: (port call, JAX call)}: each returns its entry point's
    result on _inputs()."""
    xs, ms, obs = _inputs()
    t = torch.from_numpy
    j = jnp.asarray
    return {
        "cluster_spatial 8": (
            lambda: sp.cluster_spatial(make_mesh(8, "space", "cpu"),
                                       t(xs[0]), t(obs[0]), *_cl(CFG)),
            lambda: jsp.cluster_spatial(_jax_mesh((8,), ("space",)),
                                        j(xs[0]), j(obs[0]), *_cl(JCFG_S))),
        # against the JAX result on 8 shards, which is its result on any
        # shard count (tests/test_spatial.py), one compile fewer
        "cluster_spatial 4": (
            lambda: sp.cluster_spatial(make_mesh(4, "space", "cpu"),
                                       t(xs[0]), t(obs[0]), *_cl(CFG)),
            lambda: jsp.cluster_spatial(_jax_mesh((8,), ("space",)),
                                        j(xs[0]), j(obs[0]), *_cl(JCFG_S))),
        "cluster_spatial_2d": (
            lambda: sp.cluster_spatial_2d(make_mesh_2d(2, 4, "cpu"), t(xs),
                                          t(obs), *_cl(CFG)),
            lambda: jsp.cluster_spatial_2d(
                _jax_mesh((2, 4), ("data", "space")), j(xs), j(obs),
                *_cl(JCFG_S))),
        "device_frame_step_spatial": (
            lambda: fs.device_frame_step_spatial(
                make_mesh(8, "space", "cpu"), t(xs[0]), t(ms[0]), CFG),
            lambda: jfs.device_frame_step_spatial(
                _jax_mesh((8,), ("space",)), j(xs[0]), j(ms[0]), JCFG_S)),
        "sharded_batch_step": (
            lambda: sh.sharded_batch_step(make_mesh(2, "data", "cpu"),
                                          t(xs), t(ms), CFG),
            lambda: jsh.sharded_batch_step(jsh.make_mesh(2), j(xs), j(ms),
                                           JCFG_S)),
        "sharded_pipeline_2d": (
            lambda: sh.sharded_pipeline_2d(make_mesh_2d(2, 4, "cpu"), t(xs),
                                           t(ms), CFG),
            lambda: jsh.sharded_pipeline_2d(
                _jax_mesh((2, 4), ("data", "space")), j(xs), j(ms),
                JCFG_S)),
    }


def _fields(tree, prefix=""):
    """{dotted field name: numpy leaf} of a tree of NamedTuples."""
    if hasattr(tree, "_asdict"):
        out = {}
        for k, v in tree._asdict().items():
            out.update(_fields(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_fields(v, f"{prefix}{i}."))
        return out
    return {prefix.rstrip("."): np.asarray(tree)}


def _assert_equal_to_jax(case, got, want):
    """The port's result against the JAX package's: planes within 1e-5
    (test_torch_batched.py's rule), every other field bit for bit. The
    x-band GPF of the spatial step may differ from the JAX one by float32
    summation order (test_torch_spatial.py's tolerance); where its
    labels differ, its clustering is held against the JAX x-band
    clustering of the port's own obstacle mask instead."""
    g, w = _fields(to_numpy(got)), _fields(want)
    assert g.keys() == w.keys(), case
    seg_key = next((k for k in ("seg.labels", "0.labels") if k in g), None)
    if seg_key is not None and not np.array_equal(g[seg_key], w[seg_key]):
        assert case == "device_frame_step_spatial", case
        xs, ms, _ = _inputs()
        n = int(ms[0].sum())
        seg = g[seg_key]
        assert int(np.sum(seg[:n] != w[seg_key][:n])) <= max(2, n // 1000)
        w = {f"clustering.{k}": v for k, v in _fields(jsp.cluster_spatial(
            _jax_mesh((8,), ("space",)), jnp.asarray(xs[0]),
            jnp.asarray(ms[0] & (seg == SEG_OBSTACLE)),
            *_cl(JCFG_S))).items()}
        w["clustering.overflow"] = g["clustering.overflow"] * 0
    for k in w:
        assert g[k].shape == w[k].shape, (case, k)
        if "planes." in k:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, err_msg=k)
        else:
            assert g[k].dtype == w[k].dtype, (case, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{case} {k}")


CASES = ("cluster_spatial 8", "cluster_spatial 4", "cluster_spatial_2d",
         "device_frame_step_spatial", "sharded_batch_step",
         "sharded_pipeline_2d")


# one frame here; the frame batches in test_torch_sharded_compiled.py,
# so that the two files' JAX compiles run on two test workers
SINGLE_FRAME = ("cluster_spatial 8", "cluster_spatial 4",
                "device_frame_step_spatial")


def check_compiled_route_matches_jax(case):
    """The entry point on its compiled route (through the seam) equals
    the JAX package's function; its one registered graph replays each
    call, and the second call leaves the first call's tensors as they
    were."""
    port, jax_call = _calls()[case]
    first = port()
    saved = [t.clone() for t in leaves(first)]
    second = port()
    (step,) = compiled.programs().values()
    assert step.replays == 2
    assert all(torch.equal(a, b) for a, b in zip(leaves(first), saved))
    assert all(a is not b for a, b in zip(leaves(first), leaves(second)))
    _assert_equal_to_jax(case, first, jax_call())
    assert all(torch.equal(a, b) for a, b in zip(leaves(second), saved))


@pytest.mark.parametrize("case", SINGLE_FRAME)
def test_compiled_route_matches_jax(case, graph_route):
    check_compiled_route_matches_jax(case)


def test_equal_meshes_share_one_graph(graph_route):
    """Two meshes of one layout share one registered graph; a mesh of
    another layout, another config or another cloud size gets its own;
    live_graphs() counts them; a released graph (one entry, then all) is
    captured again at the next call, with the same result."""
    xs, _, obs = _inputs()
    x, o = torch.from_numpy(xs[0]), torch.from_numpy(obs[0])
    live = compiled.live_graphs()

    def call(mesh, cfg=CFG, n=CAP):
        return sp.cluster_spatial(mesh, x[:n], o[:n], *_cl(cfg))
    want = call(make_mesh(8, "space", "cpu"))
    call(make_mesh(8, "space", "cpu"))
    assert len(compiled.programs()) == 1
    (key, step), = compiled.programs().items()
    assert program_name(key) == "cluster_spatial 8"
    assert step.replays == 2 and compiled.live_graphs() == live + 1
    call(make_mesh(4, "space", "cpu"))
    call(make_mesh(8, "space", "cpu"), CFG.replace(
        clustering=dataclasses.replace(CFG.clustering, min_cluster_size=3)))
    call(make_mesh(8, "space", "cpu"), n=CAP // 2)
    assert len(compiled.programs()) == 4
    assert compiled.live_graphs() == live + 4
    assert compiled.release_graphs(key) == 1
    assert key not in compiled.programs()
    assert compiled.live_graphs() == live + 3 and step.outputs is None
    again = call(make_mesh(8, "space", "cpu"))
    assert compiled.programs()[key] is not step
    assert compiled.programs()[key].replays == 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(again),
                                                  leaves(want)))
    assert compiled.release_graphs() == 4
    assert compiled.live_graphs() == live and not compiled.programs()


BODIES = ((sp, "_cluster_bands"), (fs, "_cluster_bands"), (fs, "_gpf_bands"),
          (fs, "_step_spatial"), (sh, "_batch_step"), (sh, "_pipeline_2d"))


@pytest.mark.parametrize("case", CASES)
def test_a_failed_capture_raises_from_each_entry_point(case, graph_route,
                                                        monkeypatch):
    """A capture that fails raises out of the entry point, registers
    nothing, and no eager body of the parallel path runs in its place."""
    ran = []
    for mod, name in BODIES:
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: ran.append(
            _n))

    def failing(run, device):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(compiled, "capture", failing)
    with pytest.raises(RuntimeError, match="not permitted"):
        _calls()[case][0]()
    assert ran == [] and not compiled.programs()


def test_the_cpu_runs_the_entry_points_eagerly():
    """Without the seam the CPU route is eager: the results equal the
    eager bodies' and nothing is registered."""
    xs, _, obs = _inputs()
    mesh = make_mesh(8, "space", "cpu")
    got = sp.cluster_spatial(mesh, torch.from_numpy(xs[0]),
                             torch.from_numpy(obs[0]), *_cl(CFG))
    want = sp._cluster_bands(mesh, "space", torch.from_numpy(xs[:1]),
                             torch.from_numpy(obs[:1]), *_cl(CFG))
    assert all(torch.equal(g, w[0]) for g, w in zip(got, want))
    assert not compiled.programs()


def test_node_kinds_and_nccl_nodes_read_from_a_graph_print():
    """node_kind, node_kinds() and nccl_nodes() on CUDA's DOT print (the
    labels of an H100 print): a KERNEL node of an NCCL kernel counts as
    an NCCL node, a PyTorch kernel does not, and a MEMCPY node (what NCCL
    captures on a one-rank group) and a MEMSET node are kinds of their
    own."""
    dot = "\n".join([
        "digraph dot {",
        '"graph_0_node_0"[style="bold" shape="record" label="{KERNEL\n| {ID '
        '| 0 (topoId: 3) | _Z29ncclDevKernel_AllGather_RING_LL24ncclDevKern'
        'elArgsStorageILm4096EE\\<\\<\\<2,640,0\\>\\>\\>}\n}"];',
        '"graph_0_node_1"[style="bold" shape="record" label="{KERNEL\n| {ID '
        '| 1 (topoId: 2) | _ZN2at6native29vectorized_elementwise_kernelILi4'
        'EEEvi\\<\\<\\<1,128,0\\>\\>\\>}\n}"];',
        '"graph_0_node_2"[style="solid" shape="record" label="{\nMEMCPY\n| '
        '{{ID | node handle} | {2 (topoId: 1) | 0x1}}\n| {kind | DtoD '
        '(DEVICE to DEVICE)}\n}"];',
        '"graph_0_node_3"[style="solid" style="solid" shape="record" '
        'label="{MEMSET\n| {{ID | node handle} | {3 (topoId: 0) | 0x2}}}"];',
        '"graph_0_node_0" -> "graph_0_node_1" [style="solid"];', "}"])
    step = object.__new__(compiled.CompiledStep)
    step._dot = dot
    assert [compiled.node_kind(n) for n in compiled.dot_nodes(dot)] == [
        "KERNEL", "KERNEL", "MEMCPY", "MEMSET"]
    assert step.node_kinds() == {"KERNEL": 2, "MEMCPY": 1, "MEMSET": 1}
    assert step.nccl_nodes() == 1
