"""PyTorch port: the parallel path's frame-batch entry points on their
compiled route, on the CPU, against the JAX package.

``cluster_spatial_2d`` on 2 x 4, ``sharded_batch_step`` over 2 data
shards and ``sharded_pipeline_2d`` on 2 x 4, each on the compiled route
through test_torch_compiled.py's seam, equal the JAX package's functions
on test_torch_parallel_compiled.py's two small street scenes, and a
second call leaves the first call's tensors as they were. A file of its
own so that its JAX compiles (the 2-D clustering, shared by the
pipeline's, the vmapped step and the 2-D segmentation) and those of
test_torch_parallel_compiled.py run on two test workers.
"""

import pytest

from test_torch_compiled import eager_capture, graph_route  # noqa: F401
from test_torch_parallel_compiled import (check_compiled_route_matches_jax,
                                          no_registered_graphs)  # noqa: F401


@pytest.mark.parametrize("case", ["cluster_spatial_2d", "sharded_batch_step",
                                  "sharded_pipeline_2d"])
def test_compiled_route_matches_jax(case, graph_route):
    check_compiled_route_matches_jax(case)
