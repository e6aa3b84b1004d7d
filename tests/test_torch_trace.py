"""PyTorch port: each frame's trace in ``FrameMetrics``, on the CPU.

ReplayStream's eager route on small synthetic frames: the spans of a
frame tile its publication to its outputs (runtime/spans.py; on the CPU
the step runs inside the dispatch, and so do its stamped stages), the
host stage's parts make ``t_host_ms``, the stamped step's payload is the
packed step's word for word, its counters are the debug path's counts,
realtime sequence numbers are those the benchmark rebuilds from
``frames_dropped``, ``deadline_missed`` times publication to outputs,
a realtime frame is consumed as soon as the next publication leaves time
(the window bounds the frames in flight only when the consumer falls
behind) with the closed loop's outputs, and ``cli run`` prints the
medians.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_processing_tpu_torch import cli
from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
from lidar_processing_tpu_torch.io.pcd import write_pcd_xyzi
from lidar_processing_tpu_torch.io.synthetic import street_scene
from lidar_processing_tpu_torch.kernels.stamp import stamp
from lidar_processing_tpu_torch.ops import stixel as tsx
from lidar_processing_tpu_torch.ops.segmentation import gpf_segment_sorted
from lidar_processing_tpu_torch.runtime import pipeline as tpipe
from lidar_processing_tpu_torch.runtime import spans as tspans
from lidar_processing_tpu_torch.runtime.stream import ReplayStream
from lidar_processing_tpu_torch.types import SEG_OBSTACLE

CAP = 4096
CFG = DEFAULT_CONFIG.replace(pipeline=dataclasses.replace(
    DEFAULT_CONFIG.pipeline, max_points=CAP, max_obstacle_points=CAP,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192))
TOL = 0.5e-3      # seconds
HOST = ("host.decode", "host.assemble", "host.chi_hulls", "host.caps")
# the host side of a frame's chain, from its publication
CHAIN = ("stream.lag", "stream.dispatch", "stream.hold",
         "stream.device_wait", "host.decode", "host.assemble",
         "host.chi_hulls", "host.caps", "host.assemble", "host.counts")


def _config(rate_hz: float):
    return CFG.replace(pipeline=dataclasses.replace(CFG.pipeline,
                                                    replay_rate_hz=rate_hz))


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames")
    for seed in (0, 1):
        write_pcd_xyzi(path / f"{seed:06d}.pcd", *street_scene(seed, "small"))
    return str(path)


def _run(stream, n, realtime):
    """(stream, metrics, outputs) of an n-frame run."""
    got = list(stream.run(n, realtime=realtime))
    return stream, [m for _, m in got], [out for out, _ in got]


@pytest.fixture(scope="module")
def closed(frames):
    """Back to back, 5 frames, a 1000 s period that every frame meets."""
    return _run(ReplayStream(_config(0.001), data_dir=frames, device="cpu"),
                5, False)


@pytest.fixture(scope="module")
def paced(frames):
    """Realtime at 5 Hz: each frame but the first waits for its
    publication, and each is consumed before the next. The step returns
    the stream's own outputs of the frame, computed once, with fresh
    stamps: the subject is the publication clock, and a CPU step's time
    grows thirtyfold in a loaded test run."""
    stream = ReplayStream(_config(5.0), data_dir=frames, device="cpu")
    outputs = [tuple(t.clone() for t in stream._step(fid))
               for fid in range(stream.num_frames)]

    def step(fid):
        payload, stats = outputs[fid]
        stats = stats.clone()[None]
        for slot in range(len(tpipe.STAGES) + 1):
            stamp(stats, slot)
        return payload, stats[0]
    stream._step = step
    list(stream.run(1))   # loads the native host stage before the clock
    return _run(stream, 4, True)


@pytest.fixture(scope="module")
def dropping(frames):
    """Realtime at 40 Hz, far past what the CPU keeps up with: frames are
    dropped, and every frame misses its period."""
    return _run(ReplayStream(_config(40.0), data_dir=frames, device="cpu"),
                4, True)


def check_chain(m):
    """The frame's host chain tiles t_published to its outputs within TOL,
    and the device's track (the queue from the dispatch's start, then the
    step's stamped stages, one after another) runs to the hold's start
    (or, where the host waited on the device, into the device wait).
    The device begins the step before the dispatch returns (on the CPU
    it runs inside it; on the card the launch of a graph of ~3k nodes
    returns after the device began it), so the track starts inside the
    dispatch."""
    chain = [s for s in m.spans if s[0] in CHAIN]
    assert tuple(n for n, _, _ in chain) == CHAIN
    queue = [s for s in m.spans if s[0] == "stream.queue"]
    stages = [s for s in m.spans if s[0].startswith("step.")]
    assert [n for n, _, _ in stages] == list(tpipe.STAGES)
    assert len(queue) == 1 and queue[0][1] == chain[1][1], queue
    assert queue[0][1] <= queue[0][2] and abs(
        queue[0][2] - stages[0][1]) <= TOL, (queue, stages[0])
    assert all(a[2] == b[1] for a, b in zip(stages, stages[1:]))
    at = m.t_published
    for name, start, end in chain:
        if name == "stream.hold":   # the stages run on from the queue
            at = max(at, stages[-1][2])
        if name == "stream.device_wait" and start < at - TOL:
            # hold or device wait: an empty hold, the host waited on the
            # device, and the wait ends after the stages did
            assert end >= at - TOL, (name, end - at)
        else:
            assert abs(start - at) <= TOL and end >= start, (
                name, start - at)
        at = end
    assert sorted(m.device_ms) == sorted(tpipe.STAGES)
    for name, start, end in stages:
        assert m.device_ms[name] > 0.0
        assert m.device_ms[name] == pytest.approx((end - start) * 1e3,
                                                  abs=1e-3)


def causal(m, err: float) -> bool:
    """Whether, within `err` seconds, the step's first stamp came after
    its dispatch began and its last before the wait on its outputs
    ended."""
    span = {n: (s, e) for n, s, e in m.spans}
    return (span["stream.dispatch"][0] <= span["step.segment"][0] + err
            and span["step.pack"][1] <= span["stream.device_wait"][1] + err)


@pytest.mark.parametrize("run", ["closed", "paced", "dropping"])
def test_spans_tile_publication_to_outputs(run, request):
    stream, metrics, _ = request.getfixturevalue(run)
    for m in metrics:
        check_chain(m)
        assert causal(m, stream.clock_error_ns * 1e-9)
        waits = [s for s in m.spans if s[0] == "stream.publication_wait"]
        if run == "paced" and m.seq > 0:
            # the wait ends where the frame's dispatch starts
            assert len(waits) == 1 and waits[0][2] == m.spans[2][1]
            assert waits[0][2] - m.t_published <= 0.05
        if run == "closed":
            assert not waits and m.t_published == m.spans[1][1]


def test_host_parts_sum_to_t_host_ms(closed):
    for m in closed[1]:
        parts = sum(tspans.total_ms(m.spans, name) for name in HOST)
        assert parts == pytest.approx(m.t_host_ms, rel=0.02)
        assert tspans.total_ms(m.spans, "host.counts") > 0.0


def test_counters_equal_the_debug_path(closed):
    """tier_pairs, tier_links and uf_edges equal what cluster_debug counts
    on the same sweep and obstacle mask, in the fused path's sorted order:
    the tier tables' pair counts (without the chunked-pair column), the
    tested pairs that link, and n_edges."""
    stream, metrics, _ = closed
    for m in metrics[:2]:
        x, mask = stream.xyz[m.frame_id], stream.mask[m.frame_id]
        ss = gpf_segment_sorted(x, mask, CFG.segmentation)
        _, dbg = tsx.cluster_debug(ss.xyz, ss.valid & (
            ss.labels == SEG_OBSTACLE), CFG.clustering, CFG.pipeline)
        assert int(dbg["tiers1"][-1]) == int(dbg["tiers2"][-1]) == 0
        ambiguous = ((torch.arange(dbg["pu"].shape[-1]) < dbg["n_snp"])
                     & ~dbg["impossible"] & ~dbg["certain"])
        links = ((dbg["link1"] & dbg["intra_tests1"]).sum()
                 + (dbg["link2"] & dbg["intra_tests2"]).sum()
                 + (dbg["snp_edge"] & ambiguous).sum())
        assert m.counters == {
            "tier_pairs": int(dbg["tiers1"][:-1].sum()
                              + dbg["tiers2"][:-1].sum()),
            "tier_links": int(links), "uf_edges": int(dbg["n_edges"])}
        assert 0 < m.counters["tier_links"] <= m.counters["tier_pairs"]


def test_stamped_step_keeps_the_payload(closed):
    """The stamped step's payload is the packed step's, word for word,
    and its stamps rise stage by stage."""
    stream = closed[0]
    x, m = stream.xyz[:2], stream.mask[:2]
    payload, stats = tpipe.device_frame_step_stamped_batched(x, m, CFG)
    assert torch.equal(payload,
                       tpipe.device_frame_step_packed_batched(x, m, CFG))
    assert stats.shape == (2, tpipe.STATS_WORDS)
    stamps = stats[:, :len(tpipe.STAGES) + 1]
    assert bool((stamps[:, 1:] > stamps[:, :-1]).all())


def test_realtime_seq_matches_the_rebuilt_sequence(dropping):
    """seq is what the benchmark rebuilds from frames_dropped (each
    delivery the last seq + 1 + its drops, its frame seq modulo the
    resident frames), and each publication time lies on the schedule."""
    stream, metrics, _ = dropping
    period = 1.0 / 40.0
    seq = -1
    for m in metrics:
        seq = seq + 1 + m.frames_dropped
        assert (m.seq, m.frame_id) == (seq, seq % stream.num_frames)
        assert m.t_published - metrics[0].t_published == pytest.approx(
            (m.seq - metrics[0].seq) * period, abs=1e-6)
    assert sum(m.frames_dropped for m in metrics) > 0


def test_deadline_is_publication_to_outputs(closed, dropping):
    """Frames that finish inside the period do not miss; those that take
    longer do."""
    for metrics, period, missed in ((closed[1], 1000.0, False),
                                    (dropping[1], 1.0 / 40.0, True)):
        for m in metrics:
            took = m.spans[-1][2] - m.t_published
            assert (took > period) is missed
            assert m.deadline_missed is missed


@pytest.mark.parametrize("run", ["closed", "paced", "dropping"])
def test_realtime_consumes_while_the_next_publication_leaves_time(run,
                                                                  request):
    """Realtime: a frame is consumed as soon as the next publication
    leaves time (paced: before it, with an empty hold), and once the
    consumer falls behind (dropping) the window consumes a frame only
    when queue_depth newer ones are in flight, as back to back always."""
    stream, metrics, _ = request.getfixturevalue(run)
    depth = stream.config.pipeline.queue_depth
    period = 1.0 / stream.config.pipeline.replay_rate_hz

    def start(m, name):
        return next(s for n, s, _ in m.spans if n == name)
    dispatched = [start(m, "stream.dispatch") for m in metrics]
    full = 0
    for m in metrics:
        # frames dispatched after this one before its consumption began
        newer = sum(start(m, "stream.dispatch") < t
                    < start(m, "stream.device_wait") for t in dispatched)
        assert newer <= depth
        if run == "paced":
            assert m.consumed_early and newer == 0
            assert m.spans[-1][2] < m.t_published + period
            assert m.frames_dropped == 0
            assert tspans.total_ms(m.spans, "stream.hold") < 1.0
        if newer == depth or run == "closed":
            assert not m.consumed_early
        full += newer == depth
    if run == "dropping":
        assert full > 0 and sum(m.frames_dropped for m in metrics) > 0


def test_paced_outputs_equal_the_closed_loop(closed, paced):
    """The same frames give the same outputs whichever policy consumed
    them: the paced run's against the closed loop's, by frame id."""
    want = {m.frame_id: out for m, out in zip(closed[1], closed[2])}
    assert [m.frame_id for m in paced[1]] == [0, 1, 0, 1]
    for m, out in zip(paced[1], paced[2]):
        for field in tpipe.FrameOutputs._fields:
            np.testing.assert_equal(getattr(out, field),
                                    getattr(want[m.frame_id], field),
                                    err_msg=field)


def test_spans_run_inside_the_profiler_only_while_it_records(monkeypatch):
    """A chain's spans are record_function ranges in torch.profiler's
    events while it records, and no profiler call is made otherwise."""
    spans = tspans.Spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        spans.begin("test.first")
        spans.begin("test.second")
        spans.begin("test.second")          # runs on
        spans.end()
    names = {e.name for e in prof.events()}
    assert {"test.first", "test.second"} <= names
    assert [n for n, _, _ in spans.record] == ["test.first", "test.second"]
    assert spans.record[0][2] == spans.record[1][1]

    def refuse(name):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = tspans.Spans()
    off.begin("test.off")
    off.end()
    assert [n for n, _, _ in off.record] == ["test.off"]
    assert tspans.total_ms(off.record, "test.none") is None


def test_cli_run_prints_the_medians(frames, monkeypatch, capsys):
    """cli run's summary: the median of each span, device stage and
    counter, after the per-frame lines."""
    monkeypatch.setattr(cli, "DEFAULT_CONFIG", CFG)
    assert cli.main(["run", "--device", "cpu", "--data-dir", frames,
                     "--frames", "3"]) == 0
    text = capsys.readouterr().out
    assert text.count("\nframe ") + text.startswith("frame ") == 3
    lines = {ln.split(" p50: ")[0]: ln for ln in text.splitlines()
             if " p50: " in ln}
    assert {"spans", "device stages", "counters"} <= set(lines)
    for name in ("stream.hold", "host.chi_hulls"):
        assert f" {name}=" in lines["spans"]
    for name in tpipe.STAGES:
        assert f" {name}=" in lines["device stages"]
    for name in tpipe.COUNTERS:
        assert f" {name}=" in lines["counters"]
