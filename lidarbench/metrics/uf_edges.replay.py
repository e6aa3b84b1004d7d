"""Mean live edges a frame that ``union_find`` takes, over the window's
delivered frames: ``FrameMetrics.counters["uf_edges"]``, the step's
``n_edges`` (ops/stixel.py), counted inside the step's graph."""

from lidarbench.program import mean_counter


def read(ctx):
    return mean_counter(ctx, "uf_edges")
