"""``MeshInfo`` — the record the protocols' ``psum_mix`` reads (the
counterpart of ``repro.sharding.rules.MeshInfo`` / ``make_mesh_info``).

The JAX record names a device mesh, its data axes, its ``model`` axis and
a sharding strategy for that axis. The port's mesh is a
``torch.distributed`` process group whose ranks lie along the client
(data) axes, one client a rank; the model axis is 1, so there is no
``tp_axis`` and no strategy: every architecture is data-parallel here, and
``make_mesh_info`` raises for a mesh whose model axis is larger.

A grouped psum (JAX's ``axis_index_groups``) is an ``all_reduce`` over
one ``new_group`` per group. ``torch.distributed`` requires every rank to
create every group, members or not, in the same order, so a partition's
groups are made together (``build_groups``) the first time it is used;
engines make theirs when they are constructed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshInfo:
    """The client axes of a mesh on a process group: rank ``rank`` of
    ``world_size`` holds the client rows ``clients`` (one client a rank:
    ``(rank,)``). ``group`` is the process group (None: the default
    group); ``dp_axes`` are the mesh's client axes, ``('data',)`` or
    ``('pod', 'data')``."""
    group: Optional[object]
    rank: int
    world_size: int
    dp_axes: Tuple[str, ...]
    clients: Tuple[int, ...]
    _groups: Dict[Tuple[int, ...], object] = field(
        default_factory=dict, compare=False, repr=False)

    def _global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def build_groups(self, partitions: Sequence[Sequence[Sequence[int]]]
                     ) -> None:
        """Make the process group of every group of ``partitions`` (each
        a partition of the ranks into groups) not made yet, in order.
        Singletons need none (a psum over one rank is the identity) and a
        group of every rank is ``group`` itself. Every rank must make the
        same calls in the same order."""
        for part in partitions:
            for g in part:
                key = tuple(int(r) for r in g)
                if (len(key) in (1, self.world_size)
                        or key in self._groups):
                    continue
                self._groups[key] = dist.new_group(
                    [self._global_rank(r) for r in key])

    def psum(self, x: torch.Tensor, groups=None) -> torch.Tensor:
        """Sum ``x`` IN PLACE over the ranks of this rank's group of the
        partition ``groups`` (None: over every rank) and return it: one
        ``all_reduce(SUM)``; nothing for a singleton group."""
        if groups is not None:
            mine = next(tuple(int(r) for r in g) for g in groups
                        if self.rank in g)
            if len(mine) == 1:
                return x
            if len(mine) < self.world_size:
                if mine not in self._groups:
                    self.build_groups([groups])
                dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                group=self._groups[mine])
                return x
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


def make_mesh_info(cfg, mesh) -> MeshInfo:
    """The ``MeshInfo`` of this rank on ``mesh`` (``launch.mesh.Mesh``)
    for the model ``cfg`` (read by the JAX package for its model-axis
    strategy; here every architecture is data-parallel). Raises when the
    mesh's model axis is larger than 1, or when its client axes do not
    hold one rank each."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if sizes.get("model", 1) != 1:
        raise NotImplementedError(
            f"the port's mesh has no model axis: got model="
            f"{sizes['model']} (tensor parallelism is not ported; use "
            "model=1)")
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    rank = dist.get_rank(mesh.group)
    world = dist.get_world_size(mesh.group)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    if dp != world:
        raise ValueError(f"mesh client axes {dp_axes} hold {dp} ranks, but "
                         f"the process group has {world}")
    return MeshInfo(group=mesh.group, rank=rank, world_size=world,
                    dp_axes=dp_axes, clients=(rank,))
