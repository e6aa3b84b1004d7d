"""The port's device mesh: named axes of shards held by the ranks of a
``torch.distributed`` process group.

Counterpart of the JAX package's ``jax.sharding.Mesh`` as
``lidar_processing_tpu/parallel/sharded.py::make_mesh`` / ``make_mesh_2d``
build it. An axis has n SHARDS (the JAX mesh's devices along it); the
ranks of the process group hold them, each rank ``n // ranks_on_axis``
consecutive shards, which it runs as ONE batch (the port's ops take a
leading batch axis). With no process group initialised, one rank holds
every shard. That is how one card holds an 8-shard axis: NCCL refuses two
ranks on one GPU, so the card is one rank with 8 shards, where the JAX
package used 8 virtual CPU devices. A mesh never moves work to the CPU
unless the caller passes ``device="cpu"``.

Ranks lie over the axes in row-major order (the last axis varies
fastest). ``make_mesh_2d`` gives the data axis as many ranks as divide
both the world and its shards (frames need no communication), the space
axis the rest.

Each collective has two parts, and the same code serves every layout:

  * the LOCAL part, along the rank's own shard axis: a shift for
    ``ppermute``, a concatenation for ``all_gather``;
  * the DISTRIBUTED part, over the axis' process group: ``all_gather``
    for the gathers, ``batch_isend_irecv`` for the neighbour shift.

The distributed part runs whenever the mesh has a process group, also on
an axis of one rank (so a one-card run goes through NCCL). A 1-D mesh
uses the default group. The first mesh of more than one axis that a
process group sees with a given layout of ranks is a collective: its
axis groups come from ``new_group``, so every rank must build it, in the
same order as the other ranks; the groups are kept for the life of the
process group, and later meshes of that layout reuse them. Sums over
shards (``sum_shards``) gather every shard's partial and add them in
shard order 0..S-1 over a fixed tree: the same bits in every layout,
where ``all_reduce``'s order would belong to NCCL or gloo.

On the card every public entry point of the parallel path runs its
program through ``Mesh.run``: captured once as a CUDA graph per (program,
``Mesh.layout``, configs, input shape) and replayed (runtime/compiled.py),
its collectives inside the graph. The communicator exists before the
capture (the eager warm-up steps run the first collective), ``new_group``
stays at mesh construction, outside any capture, and the collectives
take only the capture-safe forms used here: ``all_gather`` into equal
parts, ``batch_isend_irecv`` waited on the current stream. On the CPU
(gloo) the programs run eagerly.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..ops.segmentation import _tree_sum
from ..runtime import compiled


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world():
    """(rank, world size) of the default process group, (0, 1) without."""
    if _initialised():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# (default process group, ranks per axis) -> this rank's group of each
# axis; emptied when the default group changes
_AXIS_GROUPS: dict = {}


def _device(device) -> torch.device:
    """The card (this process' current CUDA device) unless the caller
    names a device; never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh runs on a CUDA GPU and none is "
                           "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class Mesh:
    """Named axes of shards over the ranks of the default process group.

    shards: axis name -> shards along it (ordered: the first axis is the
    outermost); ranks: axis name -> ranks along it, each dividing its
    shards. ``shape`` and ``axis_names`` read as the JAX mesh's.
    """

    def __init__(self, shards: Dict[str, int], ranks: Dict[str, int],
                 device=None):
        rank, world = _world()
        if math.prod(ranks.values()) != world:
            raise ValueError(f"ranks {ranks} do not cover the world of "
                             f"{world}")
        for axis, n in shards.items():
            if n <= 0 or n % ranks[axis]:
                raise ValueError(f"{n} {axis} shards do not divide over "
                                 f"{ranks[axis]} ranks")
        self.axis_names = tuple(shards)
        self.shape = dict(shards)
        self.ranks = dict(ranks)
        self.device = _device(device)
        self.rank = rank
        # this rank's coordinate on each axis (row-major, last fastest)
        self.coord, stride, self._stride = {}, 1, {}
        for axis in reversed(self.axis_names):
            self.coord[axis] = (rank // stride) % ranks[axis]
            self._stride[axis] = stride
            stride *= ranks[axis]
        self.groups = self._groups() if _initialised() else {}
        # what fixes a program captured on this mesh: equal layouts share
        # a graph (the JAX package's lru_cache over a hashable Mesh)
        self.layout = (tuple(self.shape.items()), tuple(self.ranks.items()),
                       rank, self.device,
                       dist.group.WORLD if _initialised() else None)

    def _groups(self) -> Dict[str, object]:
        """Each axis' process group: the ranks that differ from this one
        only on that axis. ``new_group`` is collective, so every rank
        creates every group, in the same order, once per layout (see the
        module docstring)."""
        world = dist.group.WORLD
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: world}
        if any(key[0] is not world for key in _AXIS_GROUPS):
            _AXIS_GROUPS.clear()
        key = (world, tuple(self.ranks.items()))
        if key not in _AXIS_GROUPS:
            _AXIS_GROUPS[key] = self._new_groups()
        return _AXIS_GROUPS[key]

    def _new_groups(self) -> Dict[str, object]:
        groups = {}
        for axis in self.axis_names:
            others = [a for a in self.axis_names if a != axis]
            for combo in range(math.prod(self.ranks[a] for a in others)):
                base, rest = 0, combo
                for a in reversed(others):
                    base += (rest % self.ranks[a]) * self._stride[a]
                    rest //= self.ranks[a]
                members = [base + c * self._stride[axis]
                           for c in range(self.ranks[axis])]
                group = dist.new_group(members)
                if self.rank in members:
                    groups[axis] = group
        return groups

    def run(self, program: tuple, fn, config, xyzs: torch.Tensor,
            masks: torch.Tensor):
        """``fn(xyzs, masks, config)``, fn a program on this mesh named by
        `program`: on the card its registered graph replayed
        (``compiled.replay_copy``: a copy of every output), on the CPU
        fn itself."""
        if compiled.uses_graph(self.device):
            return compiled.replay_copy((program, self.layout), fn, config,
                                        xyzs, masks, self.device)
        return fn(xyzs, masks, config)

    def local_shards(self, axis: str) -> int:
        """Shards of `axis` this rank holds."""
        return self.shape[axis] // self.ranks[axis]

    def first_shard(self, axis: str) -> int:
        """The global index of this rank's first shard on `axis`."""
        return self.coord[axis] * self.local_shards(axis)

    def local(self, x: torch.Tensor, axis: str, dim: int = 0
              ) -> torch.Tensor:
        """This rank's consecutive slice of an axis laid out along `dim`
        (``shape[axis] * m`` entries: m a shard)."""
        per_rank = x.shape[dim] // self.ranks[axis]
        return x.narrow(dim, self.coord[axis] * per_rank, per_rank)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """Every rank's `x` (its shards along `dim`) concatenated along
        `dim` in shard order, on every rank of the axis."""
        group = self.groups.get(axis)
        if group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.ranks[axis])]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    def shift_right(self, x: torch.Tensor, axis: str, dim: int = 0
                    ) -> torch.Tensor:
        """``ppermute`` by one along `axis`: shard j gets shard j - 1's
        entry of `x` (shards along `dim`), shard 0 gets zeros. The last
        shard of rank k goes to the first shard of rank k + 1."""
        last = x.narrow(dim, x.shape[dim] - 1, 1).contiguous()
        first = torch.zeros_like(last)
        if axis in self.groups:
            c, stride = self.coord[axis], self._stride[axis]
            ops = []
            if c + 1 < self.ranks[axis]:
                ops.append(dist.P2POp(dist.isend, last, self.rank + stride))
            if c > 0:
                ops.append(dist.P2POp(dist.irecv, first, self.rank - stride))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        return torch.cat([first, x.narrow(dim, 0, x.shape[dim] - 1)], dim)

    def sum_shards(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over every shard of `axis` of x (k, ...), this rank's
        k partials: all S partials gathered, then added in shard order
        over a fixed tree, so the bits do not depend on the layout."""
        every = self.all_gather(x, axis)                    # (S, ...)
        return _tree_sum(every.movedim(0, -1))


def program_name(key: tuple) -> str:
    """"<entry point> <shards of its mesh>" (e.g. "cluster_spatial 8",
    "sharded_pipeline_2d 2x4") of a registry key of ``compiled.programs()``
    that ``Mesh.run`` made."""
    (program, layout), *_ = key
    return f"{program[0]} {'x'.join(str(n) for _, n in layout[0])}"


def make_mesh(n_shards: Optional[int] = None, axis_name: str = "data",
              device=None) -> Mesh:
    """A 1-D mesh of `n_shards` shards (default: one a rank) over every
    rank of the process group; one rank without a group. Raises
    ValueError when the ranks do not divide the shards."""
    _, world = _world()
    n = world if n_shards is None else n_shards
    return Mesh({axis_name: n}, {axis_name: world}, device)


def make_mesh_2d(n_data: int, n_space: int, device=None) -> Mesh:
    """A ('data', 'space') mesh of n_data x n_space shards: frames over
    'data', each frame's x-bands over 'space'. The data axis takes
    gcd(world, n_data) ranks, the space axis the rest; raises ValueError
    when those do not divide n_space."""
    _, world = _world()
    r_data = math.gcd(world, n_data)
    return Mesh({"data": n_data, "space": n_space},
                {"data": r_data, "space": world // r_data}, device)

