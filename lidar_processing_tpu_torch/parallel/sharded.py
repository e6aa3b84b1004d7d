"""Multi-rank execution: the mesh and the sharded pipeline steps.

Port of ``lidar_processing_tpu/parallel/sharded.py``. The reference's
only distribution is two OS processes joined by DDS pub/sub (ref:
src/processor.cpp:93-100, src/dataloader.cpp:79-81); here a mesh
(parallel/mesh.py) has two axes:

  * 'data': frames sharded over the ranks (the DP analogue of the
    reference's frame pipelining);
  * 'space': each frame's x-bands, with halo exchange and label merge
    (parallel/spatial.py).

``sharded_batch_step`` runs the per-frame step on every frame of a batch,
each rank its own frames as ONE ``device_frame_step_batched`` call; the
batched FrameResult is then gathered, so every rank holds all B frames
(as JAX's global array does). Frames are independent, so the gather is
the only collective.
"""

from __future__ import annotations

import functools

import torch

from ..config import EngineConfig
from ..ops.segmentation import gpf_segment
from ..runtime.pipeline import FrameResult, device_frame_step_batched
from ..types import SEG_OBSTACLE, ClusteringResult, map_leaves
from .mesh import Mesh, make_mesh, make_mesh_2d  # noqa: F401
from .spatial import _spatial_2d_program


def _batch_step(mesh: Mesh, xyzs: torch.Tensor, masks: torch.Tensor,
                config: EngineConfig) -> FrameResult:
    """sharded_batch_step's eager body: this rank's frames as one batched
    step, gathered over the data axis."""
    dev = mesh.device
    fr = device_frame_step_batched(mesh.local(xyzs.to(dev), "data"),
                                   mesh.local(masks.to(dev), "data"), config)
    return map_leaves(lambda t: mesh.all_gather(t, "data"), fr)


def _pipeline_2d(mesh: Mesh, xyzs: torch.Tensor, masks: torch.Tensor,
                 config: EngineConfig):
    """sharded_pipeline_2d's eager body: (SegmentationResult,
    ClusteringResult) of the batch."""
    dev = mesh.device
    xyzs, masks = xyzs.to(dev), masks.to(dev)
    seg = gpf_segment(mesh.local(xyzs, "data"), mesh.local(masks, "data"),
                      config.segmentation)
    seg = map_leaves(lambda t: mesh.all_gather(t, "data"), seg)
    obstacle = masks & (seg.labels == SEG_OBSTACLE)
    cl = _spatial_2d_program(mesh, ("data", "space"), xyzs, obstacle,
                             (config.clustering, config.pipeline,
                              config.spatial))
    return seg, ClusteringResult(*cl)


def sharded_batch_step(mesh: Mesh, xyzs: torch.Tensor, masks: torch.Tensor,
                       config: EngineConfig) -> FrameResult:
    """The per-frame pipeline over a frame batch sharded on 'data'.

    xyzs (B, N, 3) f32, masks (B, N) bool, moved to the mesh's device; B
    must be divisible by the data axis' shards (ValueError otherwise).
    Returns the batched FrameResult with leading axis B, equal leaf for
    leaf to ``device_frame_step_batched`` of the whole batch. On the card
    a captured graph per mesh layout, config and B (``Mesh.run``), the
    JAX package's jitted ``_batch_step``.
    """
    b, n_shards = xyzs.shape[0], mesh.shape["data"]
    if b % n_shards:
        raise ValueError(f"batch {b} not divisible by the {n_shards} "
                         f"shards of the data axis")
    return mesh.run(("sharded_batch_step",),
                    functools.partial(_batch_step, mesh), config, xyzs,
                    masks)


def sharded_pipeline_2d(mesh: Mesh, xyzs: torch.Tensor, masks: torch.Tensor,
                        config: EngineConfig):
    """Segment -> cluster on a 2-D (data, space) mesh.

    Frames shard over 'data' (GPF is per frame, so it stays a pure batch
    axis); each frame's clustering shards its x-bands over 'space'
    (``cluster_spatial_2d``'s program). B must equal the data axis'
    shards. Returns (SegmentationResult, ClusteringResult), both batched
    over B; the clustering of each frame is bit-identical to the
    single-device clustering of its obstacle mask. On the card one
    captured graph (``Mesh.run``) for the JAX package's two programs
    (``_seg_step_2d`` and ``cluster_spatial_2d``'s).
    """
    b = xyzs.shape[0]
    if b != mesh.shape["data"]:
        raise ValueError(f"batch {b} must equal the data axis size "
                         f"{mesh.shape['data']} (chunk larger batches)")
    return mesh.run(("sharded_pipeline_2d",),
                    functools.partial(_pipeline_2d, mesh), config, xyzs,
                    masks)
