"""The readers of the program's own spans, stamps and counters, against
stub ``FrameMetrics``: each is the mean over the window's delivered
frames, and each returns None on frames that lack its field (a program
without them) and on no frames."""

from types import SimpleNamespace

import pytest

from lidarbench import harness

SPANS = {"hold_ms.live": ("stream.hold", 1e3),
         "launch_us.replay": ("stream.dispatch", 1e6),
         "device_wait_ms.replay": ("stream.device_wait", 1e3),
         "host_decode_ms.replay": ("host.decode", 1e3),
         "chi_hull_ms.replay": ("host.chi_hulls", 1e3),
         "host_caps_ms.replay": ("host.caps", 1e3)}
STAGES = {"seg_device_ms.replay": "step.segment",
          "cluster_device_ms.replay": "step.cluster",
          "outline_device_ms.replay": "step.outline",
          "pack_device_ms.replay": "step.pack"}
COUNTERS = {"tier_pairs.replay": "tier_pairs",
            "uf_edges.replay": "uf_edges"}
PROGRAM = (list(SPANS) + list(STAGES) + list(COUNTERS)
           + ["publication_lag_ms.live", "tier_link_share.replay"])


def _frame(k: int):
    """Frame k: every span lasts (k + 1) ms, host.decode twice; stage s
    takes (s + 1) * (k + 1) ms; counters k * 10 pairs, k * 4 links."""
    t = 10.0 * k
    d = 0.001 * (k + 1)
    names = ["stream.lag", "stream.dispatch", "stream.queue", "stream.hold",
             "stream.device_wait", "host.decode", "host.decode",
             "host.assemble", "host.chi_hulls", "host.caps", "host.assemble"]
    spans = [(n, t + i * d, t + (i + 1) * d) for i, n in enumerate(names)]
    return SimpleNamespace(
        t_published=t, spans=spans,
        device_ms={s: (i + 1) * (k + 1.0)
                   for i, s in enumerate(STAGES.values())},
        counters={"tier_pairs": 10 * k, "tier_links": 4 * k,
                  "uf_edges": 100 + k})


def test_program_readers_on_stub_frames(spec):
    ctx = harness.Context([_frame(0), _frame(1)], None)
    read = {m: spec.reader(m)(ctx) for m in PROGRAM}
    for metric, (name, scale) in SPANS.items():
        per_frame = 2.0 if name == "host.decode" else 1.0
        assert read[metric] == pytest.approx(1.5e-3 * scale * per_frame)
    for i, metric in enumerate(STAGES):
        assert read[metric] == pytest.approx((i + 1) * 1.5)
    assert read["tier_pairs.replay"] == 5.0
    assert read["uf_edges.replay"] == 100.5
    assert read["tier_link_share.replay"] == pytest.approx(40.0)
    # dispatch starts one span (k + 1 ms) after publication
    assert read["publication_lag_ms.live"] == pytest.approx(1.5)


def test_program_readers_find_nothing_without_the_fields(spec):
    """A program whose FrameMetrics has none of the new fields (the
    parent's) reads None, as do no frames and frames with no pairs."""
    parent = harness.Context([SimpleNamespace(t_dispatch_ms=4.0,
                                              t_host_ms=1.5)], None)
    empty = harness.Context([], None)
    for m in PROGRAM:
        assert spec.reader(m)(parent) is None, m
        assert spec.reader(m)(empty) is None, m
    idle = harness.Context([_frame(0)], None)
    assert spec.reader("tier_link_share.replay")(idle) is None


def test_program_metrics_are_declared_for_their_cells(spec):
    """Each reader's metric is a per_layer entry with its cells listed,
    the live cell's moving its deadline share, the rest frames_per_s."""
    entries = {m["name"]: m for m in spec.bench["per_layer"]}
    for name in PROGRAM:
        m = entries[name]
        live = name.endswith(".live")
        assert m["workloads"] == [
            "kitti-hdl64e-host-outlines."
            + ("live-10hz" if live else "replay-max")]
        assert (m["moves"] == "deadline_met_share" if live
                else m["moves"] == "frames_per_s")
        assert m["source"] in ("program_span", "program_counter")


@pytest.mark.parametrize("helper, args, want", [
    ("mean_span", ("stream.hold",), 2.0),
    ("mean_span", ("stream.hold", 1e6), 2000.0),
    ("mean_stage", ("step.pack",), 3.0),
    ("mean_counter", ("uf_edges",), 7.0)])
def test_program_means_skip_frames_without_the_field(helper, args, want):
    """lidarbench/program.py's means run over the frames that carry the
    field (a frame may repeat a span: its spans add up), and are None
    where none does."""
    from lidarbench import program
    full = SimpleNamespace(
        spans=[("stream.hold", 0.0, 0.0015), ("stream.hold", 1.0, 1.0005)],
        device_ms={"step.pack": 3.0}, counters={"uf_edges": 7})
    bare = SimpleNamespace(spans=[("stream.lag", 0.0, 1.0)], device_ms={},
                           counters={})
    fn = getattr(program, helper)
    assert fn(harness.Context([full, bare, SimpleNamespace()], None),
              *args) == pytest.approx(want)
    assert fn(harness.Context([bare], None), *args) is None
