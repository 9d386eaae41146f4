"""The device mesh on torch.distributed (megatron_tpu/parallel/mesh.py).

The reference's mesh is one `jax.sharding.Mesh` with axes (dp, pp, cp, tp)
over `devices.reshape(dp, pp, cp, tp)`, tp fastest, so that the tensor
axis rides the fastest links (upstream Megatron's rank order). The port
lays the ranks of the default process group out the same way: rank r sits
where r sits in `arange(world).reshape(dp, pp, cp, tp)` (`rank_grid`), and
every axis of size > 1 gets the process groups of the ranks that differ
only along it. Under pipeline parallelism (pp > 1) the pp group of a
rank is its line of stages at its (dp, cp, tp) coordinate: the shared
leaves' grads are all-reduced over it, and `pp_ranks` names the global
rank of each of its stages, in stage order, for the schedule's sends
(`stage_rank`, parallel/pipeline.py).

A `Mesh` is what the sharded model, the train step and the checkpoint
code share: the axis sizes, this rank's coordinates, the groups, the
transport of the backend (parallel/collectives.py) and the parallel config
it was built from (`sequence_parallel`, `use_distributed_optimizer`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch.distributed as dist

from megatron_tpu_torch.config import ParallelConfig
from megatron_tpu_torch.parallel.collectives import Transport, transport_for

# Canonical mesh axis names, outermost (slowest-varying) first.
DATA_AXIS = "dp"
PIPELINE_AXIS = "pp"
CONTEXT_AXIS = "cp"
TENSOR_AXIS = "tp"
MESH_AXES = (DATA_AXIS, PIPELINE_AXIS, CONTEXT_AXIS, TENSOR_AXIS)


@dataclass(frozen=True, eq=False)
class Mesh:
    shape: dict      # axis -> size, in MESH_AXES order
    coords: dict     # axis -> this rank's coordinate
    rank: int
    groups: dict     # axis -> this rank's process group (axes of size > 1)
    transport: Optional[Transport]  # None on a mesh of one rank
    parallel: ParallelConfig
    # the world's group for host-side agreement (CPU tensors): the default
    # group under gloo, a gloo group of every rank under NCCL
    host_group: Optional[object] = None
    # the global ranks of this rank's pp line, in stage order
    pp_ranks: tuple = (0,)

    @property
    def world_size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def sequence_parallel(self) -> bool:
        return self.parallel.sequence_parallel and self.shape[TENSOR_AXIS] > 1

    @property
    def use_distributed_optimizer(self) -> bool:
        return self.parallel.use_distributed_optimizer

    @property
    def stage(self) -> int:
        return self.coords[PIPELINE_AXIS]

    def stage_rank(self, stage: int) -> int:
        """The global rank of `stage` on this rank's pp line (taken mod
        pp, so stage - 1 of stage 0 is the last)."""
        return self.pp_ranks[stage % len(self.pp_ranks)]


def _dims(parallel: ParallelConfig, world_size: int) -> dict:
    tp = parallel.tensor_parallel
    pp = parallel.pipeline_parallel
    cp = parallel.context_parallel
    dp = parallel.data_parallel or parallel.derive_dp(world_size)
    if dp * pp * cp * tp != world_size:
        raise ValueError(f"mesh {dp}x{pp}x{cp}x{tp} != {world_size} ranks")
    return dict(zip(MESH_AXES, (dp, pp, cp, tp)))


def rank_grid(parallel: ParallelConfig, world_size: int) -> np.ndarray:
    """The ranks laid out as the reference lays out its devices:
    arange(world).reshape(dp, pp, cp, tp)."""
    return np.arange(world_size).reshape(
        tuple(_dims(parallel, world_size).values()))


def build_mesh(parallel: ParallelConfig,
               world_size: Optional[int] = None) -> Mesh:
    """This rank's view of the (dp, pp, cp, tp) mesh over the default
    process group (a mesh of one rank when none is initialised); dp is
    derived from the world size when the config leaves it unset, as the
    reference derives it from its device count. Every rank must call it,
    in the same order as its other group creations: each axis's groups
    are made on every rank. `world_size`, when given, must be the group's."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    if world_size is not None and world_size != world:
        raise ValueError(f"build_mesh: world_size {world_size}, but the "
                         f"process group holds {world} ranks")
    grid = rank_grid(parallel, world)
    shape = _dims(parallel, world)
    where = np.argwhere(grid == rank)[0]
    coords = {a: int(c) for a, c in zip(MESH_AXES, where)}
    groups = {}
    for i, axis in enumerate(MESH_AXES):
        if shape[axis] == 1:
            continue
        # the lines of the grid along this axis, in one order on every rank
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[axis])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    pp_line = np.moveaxis(grid, 1, -1).reshape(-1, shape[PIPELINE_AXIS])
    pp_ranks = tuple(int(r) for r in
                     pp_line[(pp_line == rank).any(axis=1)][0])
    host_group = None
    if world > 1 and backend != "gloo":
        host_group = dist.new_group(backend="gloo")
    parallel = dataclasses.replace(parallel,
                                   data_parallel=shape[DATA_AXIS])
    return Mesh(shape=shape, coords=coords, rank=rank, groups=groups,
                transport=transport_for(backend) if world > 1 else None,
                parallel=parallel, host_group=host_group,
                pp_ranks=pp_ranks)


def single_device_mesh() -> Mesh:
    """A mesh of this one rank, outside any process group."""
    return Mesh(shape=dict.fromkeys(MESH_AXES, 1),
                coords=dict.fromkeys(MESH_AXES, 0), rank=0, groups={},
                transport=None, parallel=ParallelConfig(data_parallel=1))


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def mesh_info(mesh: Mesh) -> dict:
    return dict(mesh.shape)
