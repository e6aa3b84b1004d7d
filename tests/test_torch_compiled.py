"""PyTorch port: the compiled step (runtime/compiled.py) on the CPU.

The CPU has no CUDA graphs, so these tests replace CompiledStep's capture
seam (``compiled.capture``) with ``eager_capture``: the first call's
outputs become the static outputs, and a replay reruns the step eagerly
into them, as a graph replay overwrites its outputs; ``graph_route`` also
sends the CPU down the compiled route. Through that seam, at
test_torch_stream.py's small config: a ReplayStream on the compiled route
yields the JAX package's ReplayStream outputs frame for frame (the depth-2
window must copy the static payload before the next step overwrites it);
the wrappers count the capture's launches and no replay's; a capture that
raises makes CompiledStep and the stream raise, with no eager fallback;
the stage-timed replay on its two compiled stages yields the JAX
stream's stage-timed outputs (one JAX stream serves the module, so its
jitted step compiles once).
Without the seam CompiledStep raises on the CPU, and the CPU's route is
the eager step.
"""

import types

import pytest
import torch

from lidar_processing_tpu.runtime.stream import ReplayStream as JReplay
from lidar_processing_tpu_torch.io import pcd as tpcd
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.kernels import tier_min_d2 as ttm
from lidar_processing_tpu_torch.kernels import union_find as tuf
from lidar_processing_tpu_torch.ops import stixel as sx
from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
from lidar_processing_tpu_torch.runtime import compiled
from lidar_processing_tpu_torch.runtime.pipeline import (
    device_frame_step_packed, device_frame_step_packed_batched)
from lidar_processing_tpu_torch.runtime.stream import ReplayStream
from lidar_processing_tpu_torch.types import SEG_OBSTACLE
from test_torch_native import jax_native, jax_native_lib  # noqa: F401
from test_torch_stream import CAP, JCFG, SEEDS, TCFG, _assert_outputs_equal

leaves = torch.utils._pytree.tree_leaves


COUNTED = (ttm.tier_min_d2, tuf.cc_labels)


def eager_capture(run, device):
    """The seam's stand-in for a graph: a replay reruns the step into the
    first call's outputs and, as a graph replay does, counts no launch."""
    outputs = run()

    def replay():
        counts = [(fn, fn.launches) for fn in COUNTED]
        fresh = run()
        for fn, n in counts:
            fn.launches = n
        for out, new in zip(leaves(outputs), leaves(fresh)):
            out.copy_(new)
    return types.SimpleNamespace(replay=replay), outputs


@pytest.fixture
def graph_route(monkeypatch):
    """The compiled route on the CPU, through the seam."""
    monkeypatch.setattr(compiled, "capture", eager_capture)
    monkeypatch.setattr(compiled, "uses_graph",
                        lambda device, eager=False: True)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames")
    for seed in SEEDS:
        xyz, inten = street_scene(seed, "small")
        tpcd.write_pcd_xyzi(path / f"{seed:06d}.pcd", xyz, inten)
    return str(path)


@pytest.fixture(scope="module")
def jax_stream(frames):
    """One JAX ReplayStream over the frames for the module: its jitted
    step (a closure of the instance) compiles once."""
    return JReplay(JCFG, data_dir=frames)


def test_compiled_stream_matches_jax_stream(frames, jax_native, jax_stream,
                                            graph_route):
    """ReplayStream on the compiled route (through the seam) yields the
    JAX stream's outputs frame for frame over 3 frames (0, 1, 0): each
    payload is copied out of the static output before the next replay."""
    stream = ReplayStream(TCFG, data_dir=frames, device="cpu")
    got = list(stream.run(3))
    assert isinstance(stream.graph, compiled.CompiledStep)
    want = list(jax_stream.run(3))
    assert [m.frame_id for _, m in got] == [0, 1, 0]
    for (go, gm), (wo, wm) in zip(got, want):
        _assert_outputs_equal(go, wo)
        assert (gm.num_clusters, gm.overflow) == (wm.num_clusters,
                                                  wm.overflow)


def test_replays_count_no_python_launch(monkeypatch):
    """The wrappers count the launches made from Python: the capture's
    call counts tier_min_d2 2 and union_find (cc_labels) 1, and replays,
    which run no wrapper, add nothing (what a replay launches is read
    from the graph on the card); the step counts its replays; a call's
    payload is the eager step's; other shapes are refused, and so is a
    call after release()."""
    monkeypatch.setattr(compiled, "capture", eager_capture)
    # on the CPU a wrapper runs its twin and launches nothing: here each
    # twin call counts as the launch it stands for
    for mod, fn, twin in ((ttm, ttm.tier_min_d2, "tier_min_d2_ref"),
                          (tuf, tuf.cc_labels, "cc_labels_ref")):
        def counting(*args, _fn=fn, _real=getattr(mod, twin)):
            _fn.launches += 1
            return _real(*args)
        monkeypatch.setattr(mod, twin, counting)
    x, m = (torch.from_numpy(a) for a in pad_frame(
        street_scene(0, "small")[0], CAP))
    before = (ttm.tier_min_d2.launches, tuf.cc_labels.launches)
    step = compiled.CompiledStep(device_frame_step_packed_batched, TCFG, 1,
                                 "cpu")
    captured = (ttm.tier_min_d2.launches, tuf.cc_labels.launches)
    assert captured == (before[0] + 2, before[1] + 1)
    for _ in range(3):
        pay = step(x[None], m[None])
    assert (ttm.tier_min_d2.launches, tuf.cc_labels.launches) == captured
    assert step.replays == 3
    assert pay is step.outputs
    assert torch.equal(pay[0], device_frame_step_packed(x, m, TCFG))
    with pytest.raises(ValueError, match="captured for"):
        step(torch.stack([x, x]), torch.stack([m, m]))
    live = compiled.live_graphs()
    step.release()
    assert compiled.live_graphs() == live - 1
    with pytest.raises(RuntimeError, match="released"):
        step(x[None], m[None])


def test_a_failed_capture_raises(frames, graph_route, monkeypatch):
    """A capture that fails raises out of CompiledStep and out of the
    stream's first step; the eager step is never called in its place."""
    def failing(run, device):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(compiled, "capture", failing)
    with pytest.raises(RuntimeError, match="not permitted"):
        compiled.CompiledStep(device_frame_step_packed_batched, TCFG, 1,
                              "cpu")
    stream = ReplayStream(TCFG, data_dir=frames, device="cpu")
    with pytest.raises(RuntimeError, match="not permitted"):
        next(stream.run(1))
    assert stream.graph is None and stream._stepper is None


def test_kernel_nodes_read_from_a_graph_print():
    """kernel_nodes' parse of CUDA's DOT print: a node counts once for a
    kernel it names, mangled in any namespace or demangled, never for
    another kernel whose name holds this one's (min_d2_kernel in
    tier_min_d2_kernel), and an edge is no node."""
    sym = {"tier": "_ZN12_GLOBAL__N_118tier_min_d2_kernelEPKfiPKi",
           "uf": "_ZN50_GLOBAL__N__fa15d16e_17_RangeFactories_cu_38772b08"
                 "17union_find_kernelEPKiS1_PiiI",
           "plain": "_Z13min_d2_kernelPKfS0_",
           "torch": "_ZN2at6native29vectorized_elementwise_kernelILi4EEEvi"}

    def node(i, label):
        return (f'"graph_0_node_{i}"[style="bold" shape="record" '
                f'label="{{KERNEL\n| {{ID | {i} (topoId: {i}) | {label}'
                f'\\<\\<\\<4,256,0\\>\\>\\>}}\n| {{priority | 0}}\n}}"];')
    dot = "\n".join([
        "digraph dot {", node(0, sym["tier"]), node(1, sym["uf"]),
        '"graph_0_node_2"[style="solid" shape="record" label="{MEMSET}"];',
        node(3, sym["tier"]), node(4, sym["torch"]),
        node(5, "tier_min_d2_kernel(float const*, int)"),
        '"graph_0_node_0" -> "graph_0_node_1" [style="solid"];', "}"])
    nodes = compiled.dot_nodes(dot)
    assert len(nodes) == 6

    def count(kernel):
        return sum(compiled.names_kernel(n, kernel) for n in nodes)
    assert (count("tier_min_d2_kernel"), count("union_find_kernel"),
            count("min_d2_kernel")) == (3, 1, 0)
    assert compiled.names_kernel(sym["plain"], "min_d2_kernel")
    assert not compiled.names_kernel(sym["plain"], "tier_min_d2_kernel")


def test_compiled_step_on_the_cpu_raises(frames):
    """Without the seam the CPU has no graphs: CompiledStep raises, and
    the CPU's route, with or without ``eager``, is the eager step."""
    with pytest.raises(RuntimeError, match="no CUDA graphs"):
        compiled.CompiledStep(device_frame_step_packed_batched, TCFG, 1,
                              "cpu")
    assert not compiled.uses_graph("cpu") and compiled.uses_graph("cuda")
    assert not compiled.uses_graph("cuda", eager=True)
    stream = ReplayStream(TCFG, data_dir=frames, device="cpu")
    stream.warmup()
    assert stream.graph is None and stream._stepper is not None


def test_stage_timed_replay_on_compiled_stages_matches_jax(
        frames, jax_native, jax_stream, graph_route):
    """ReplayStream(stage_timing=True) on the compiled route (through the
    seam) yields the JAX stream's stage-timed outputs frame for frame
    over 3 frames (0, 1, 0), with every stage time set; its two stages
    are compiled steps (B = 1), equal to gpf_segment + the obstacle mask
    and to stixel.cluster of that mask; release() frees them."""
    stream = ReplayStream(TCFG, data_dir=frames, device="cpu")
    got = list(stream.run(3, stage_timing=True))
    want = list(jax_stream.run(3, stage_timing=True))
    assert [m.frame_id for _, m in got] == [0, 1, 0]
    for (go, gm), (wo, wm) in zip(got, want):
        _assert_outputs_equal(go, wo)
        assert (gm.num_clusters, gm.overflow) == (wm.num_clusters,
                                                  wm.overflow)
        for t in (gm.t_seg_ms, gm.t_cluster_ms, gm.t_hull_ms):
            assert t is not None and t >= 0.0
    seg_stage, cl_stage = stream.stage_graphs
    assert seg_stage.replays == cl_stage.replays == 3
    x, m = stream.xyz[1:2], stream.mask[1:2]
    seg, obstacle = seg_stage(x, m)
    want_seg = gpf_segment(x, m, TCFG.segmentation)
    assert all(torch.equal(a, b) for a, b in zip(leaves(seg),
                                                  leaves(want_seg)))
    assert torch.equal(obstacle, m & (want_seg.labels == SEG_OBSTACLE))
    cl = cl_stage(x, obstacle)
    want_cl = sx.cluster(x, obstacle, TCFG.clustering, TCFG.pipeline)
    assert all(torch.equal(a, b) for a, b in zip(cl, want_cl))
    stream.release()
    assert stream.stage_graphs == () and seg_stage.outputs is None
