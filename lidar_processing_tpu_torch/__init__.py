"""PyTorch + CUDA port of the LiDAR perception engine, for NVIDIA Hopper.

Runs the JAX package's default main path — GPF ground segmentation, exact
stixel-graph Euclidean clustering, device convex hulls, the packed host
payload and host chi-shape outlines — with PyTorch on one GPU, one frame
or a batch of B frames a step (``device_frame_step_batched``). The two
Pallas TPU kernels of that path (block min-distance and union-find) are
hand-written CUDA C++ for sm_90a (csrc/); every other step is plain
PyTorch. ``parallel/`` shards frames and x-bands over the ranks of a
``torch.distributed`` process group, bit-identical to one device.
``lidar_processing_tpu`` stays the reference the port is held against;
this package never imports jax.
"""

import torch

from .config import (ClusteringConfig, EngineConfig, PipelineConfig,
                     PolygonizationConfig, SegmentationConfig, SpatialConfig,
                     DEFAULT_CONFIG)
from .types import (CLUSTER_INVALID, CLUSTER_UNDEFINED, SEG_GROUND,
                    SEG_OBSTACLE, SEG_UNKNOWN)

__version__ = "0.1.0"

# the port computes in full float32, as the JAX package does: no TF32
# anywhere a matmul or convolution might be reached
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
