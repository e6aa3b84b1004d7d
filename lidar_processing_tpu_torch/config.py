"""Typed configuration tree for the TPU-native LiDAR perception engine.

A copy of ``lidar_processing_tpu/config.py`` that the PyTorch port can
import where jax is not installed (the JAX package's ``__init__`` pulls jax
in through ``types.py``); tests/test_torch_pipeline.py holds every field
and default against the original. ``PipelineConfig`` adds the step's
capacities that the JAX package keeps as module constants and that a
configuration needs to set (the intra-column tier slots, the expansion
bands, the large outline slots): ``PORT_PIPELINE_FIELDS``, whose defaults
are those constants.

Mirrors the reference's three hard-coded config structs
(ref: src/segmentation.hpp:48-56, src/clustering.hpp:42-48,
src/polygonization.hpp:51-58) plus the pipeline/runtime settings that in the
reference live as magic constants (ref: src/processor.cpp:88-90 200k
preallocation, src/dataloader.cpp:30 10 Hz publication rate).

Because a TPU program is traced to static shapes, padded buffer sizes are
first-class configuration here rather than runtime `reserve()` calls.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Ground-plane-fitting (GPF) parameters.

    Field-for-field equivalent of the reference's ``SegmentationConfiguration``
    (ref: src/segmentation.hpp:48-56); defaults are identical.
    """

    sensor_height_m: float = 1.73
    orthogonal_distance_threshold: float = 0.3
    initial_seed_threshold: float = 0.6
    number_of_iterations: int = 3
    number_of_planar_partitions: int = 2
    number_of_lower_point_representatives: int = 5000
    # Multiplier for the below-ground outlier cutoff: points with
    # z <= -z_min_outlier_scale * sensor_height_m are excluded from seed
    # selection (ref: src/segmentation.cpp:171 hard-codes -1.5).
    z_min_outlier_scale: float = 1.5


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    """Euclidean clustering parameters.

    Field-for-field equivalent of the reference's ``ClusteringConfiguration``
    (ref: src/clustering.hpp:42-48); defaults are identical. ``cluster_quality``
    is kept for API parity: in the reference's FEC it trades work for identical
    connectivity in dense clouds; the TPU engine computes exact connected
    components of the radius graph, which is order-independent (see
    ops/clustering.py docstring for the equivalence discussion).
    """

    distance_squared: float = 0.18
    cluster_quality: float = 0.5
    min_cluster_size: int = 4
    max_cluster_size: int = 2**32 - 1


@dataclasses.dataclass(frozen=True)
class PolygonizationConfig:
    """Cluster-outline extraction parameters.

    Mirrors the reference's ``PolygonizationConfiguration``
    (ref: src/polygonization.hpp:51-58) plus the live-path magic constants
    (ref: src/polygon_simplification.cpp:98 '<20 points => convex hull',
    :129 'chi=0.2', :55 '>1000 points => Chan').
    """

    polygonizer_concave: bool = True
    # vertex-count cap applied to every emitted outline via
    # Visvalingam-Whyatt decimation (ops/simplify.py) — the reference's
    # planned max_polygon_points (ref: src/polygonization.hpp:56)
    simplify_convex_by_maximum_points: bool = True
    max_points_in_polygon: int = 300
    small_cluster_size: int = 20         # below this: convex hull instead
    chi: float = 0.2                     # chi-shape concavity parameter
    chan_threshold: int = 1000           # above this: Chan's algorithm


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static shapes and runtime settings for the device pipeline.

    The reference preallocates 200k-point buffers (ref: src/processor.cpp:88-90)
    and publishes frames at 10 Hz (ref: src/dataloader.cpp:30). Here the padded
    sizes bound the traced shapes; 2**17 = 131072 covers the largest bundled
    KITTI frame (124,123 points).
    """

    max_points: int = 131072             # padded points per frame
    max_clusters: int = 256              # padded cluster slots for hull stage
    max_cluster_points: int = 4096       # padded points per cluster for hulls
    max_hull_vertices: int = 512         # padded vertices per output polygon
    # Voxel-grid clustering capacities (checked at runtime; an overflow
    # counter is reported so tests can assert sufficiency on the dataset).
    cell_capacity: int = 64          # points per cell in ambiguous-pair checks
    max_cells: int = 20480           # occupied-cell slots (measured 16,529)
    max_ambiguous_pairs: int = 131072  # ambiguous cell-pair slots (~56k/frame)
    # Stixel-clustering capacities (ops/stixel.py). Sized from the measured
    # maxima over ALL 154 bundled frames (tools/measure_caps.py, noted in
    # parentheses) with >=1.2x headroom; static caps are linear cost on TPU
    # whether occupied or not, and every violation raises overflow.
    max_obstacle_points: int = 81920   # compacted obstacle buffer (67,816)
    max_columns: int = 8192            # occupied xy columns (6,902)
    max_supernodes: int = 10240        # stixels (8,459)
    max_column_pairs: int = 40960      # 12-offset column adjacencies (33,782)
    max_sn_pairs: int = 65536          # supernode candidate pairs (58,542)
    max_edges: int = 32768             # verified radius-graph edges (20,952)
    max_live_edges: int = 8192         # spatial-sharding merge edges (6,599)
    # packed host-payload cap on compacted large-cluster points
    # (runtime/pipeline.py pack_host_payload; 154-frame max is ~60k,
    # bounded above by max_obstacle_points; overflow-counted)
    payload_large_points: int = 65536
    # Stixel exact-test tier slots of the intra-column cell pairs, one per
    # tier shape of ops/stixel.py's _TIER_SHAPES, and the supernode-pair
    # expansion bands (widths 2, 4, 8, 16): the JAX package's tables,
    # 154-frame KITTI maxima with >=1.15x headroom. Excess counts as
    # overflow.
    intra_tier_slots: Tuple[int, ...] = (2176, 64, 896, 192, 96, 64)
    expansion_band_caps: Tuple[int, ...] = (10240, 3840, 512, 64)
    # host outline slots (runtime/pipeline.py): the clusters that take no
    # device convex-hull slot; excess counts as hull overflow
    large_cluster_slots: int = 512
    replay_rate_hz: float = 10.0         # ref: src/dataloader.cpp:30
    queue_depth: int = 2                 # DDS QoS keep-last depth (processor.cpp:69)
    # Clustering backend: "stixel" (ops/stixel.py, sort/scan-based — the
    # fast path) or "cellgraph" (ops/clustering.py, neighbor-table based —
    # the original reference implementation, kept for cross-validation).
    clustering_backend: str = "stixel"

    def __post_init__(self):
        # a JSON configuration gives lists: the config stays hashable
        for name, n in (("intra_tier_slots", 6), ("expansion_band_caps", 4)):
            object.__setattr__(self, name,
                               tuple(int(v) for v in getattr(self, name)))
            if len(getattr(self, name)) != n:
                raise ValueError(f"PipelineConfig.{name} needs {n} entries, "
                                 f"got {getattr(self, name)}")


# the PipelineConfig fields the JAX package keeps as module constants
PORT_PIPELINE_FIELDS = ("intra_tier_slots", "expansion_band_caps",
                        "large_cluster_slots")


@dataclasses.dataclass(frozen=True)
class SpatialConfig:
    """Static shapes for spatial grid-block sharding (parallel/spatial.py).

    One cloud is split into x-bands (band width >= the clustering radius, so
    only adjacent blocks can be connected), one band per device along the
    'space' mesh axis — the TPU-native analogue of the reference's planar
    x-partitioning (ref: src/segmentation.cpp:104-149) applied to the whole
    pipeline. Caps are per BLOCK; violations raise the overflow counter.
    """

    block_points: int = 32768        # padded points per block (mult. of 32)
    block_clusters: int = 4096       # local component slots per block
    halo_points: int = 2048          # margin points exchanged per boundary
    # per-block caps for the local stixel run (scaled-down PipelineConfig)
    block_cells: int = 16384
    block_columns: int = 8192
    block_supernodes: int = 12288
    block_column_pairs: int = 32768
    block_sn_pairs: int = 32768
    block_edges: int = 16384
    block_live_edges: int = 8192


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level config bundle for the whole engine."""

    segmentation: SegmentationConfig = SegmentationConfig()
    clustering: ClusteringConfig = ClusteringConfig()
    polygonization: PolygonizationConfig = PolygonizationConfig()
    pipeline: PipelineConfig = PipelineConfig()
    spatial: SpatialConfig = SpatialConfig()

    def replace(self, **kwargs) -> "EngineConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = EngineConfig()
