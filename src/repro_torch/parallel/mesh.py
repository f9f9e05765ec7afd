"""The port's device mesh: this rank's place on named axes, and the
collectives of one axis line.

Counterpart of the ``jax.sharding.Mesh`` the reference's sharded serving
step runs on. The reference is one controller over every device: GSPMD
and ``shard_map`` insert the collectives. Here every rank runs the same
program on its own shard and calls them itself:

* ``RankMesh(axis_names, shape, rank, device, groups)``: ``rank`` is the
  row-major index into ``shape`` (the reference's ``mesh.devices``
  layout); ``groups`` maps each axis of size > 1 to the process group of
  the ranks that share every other coordinate with this one (this rank's
  line along the axis). A size-1 axis has no group, and its collectives
  return their input. ``RankMesh.build`` makes those groups as
  ``ProcessGroupGloo(PrefixStore(f"{axis}/{line}", store), i, n)``.
* ``axis_names``, ``shape``, ``devices.shape``, ``axis_size``,
  ``axis_index`` and ``coords``: what ``parallel.sharding`` reads, as the
  reference reads a ``Mesh``.
* ``psum`` / ``pmax`` / ``all_gather`` / ``all_to_all`` over one axis,
  each counted on ``collectives`` by the reference's HLO name
  (``all-reduce``, ``all-gather``, ``all-to-all``; ``pmax`` is an
  all-reduce there too). Only ``allreduce`` is called, the one
  collective both gloo and NCCL take for CUDA tensors with every op
  here: the gather and the all-to-all are all-reduces of zero-filled
  buffers with one writer per element, which is exact. ``pmax`` reduces
  with MAX. Nothing falls back: a collective that fails raises.

Every group is explicit, never the default one, so ranks can be threads
of one process (the CPU tests) or one process per card; two ranks that
share a card take gloo (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import collections
import datetime
import types
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.serving import instrument as INS

class RankMesh:
    """One rank's view of a mesh ``shape`` over ``axis_names``."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int, device, groups: Optional[Dict[str, object]]
                 = None):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} against shape "
                             f"{self.shape}")
        self.size = int(np.prod(self.shape))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.device = torch.device(device)
        self.coords = tuple(int(c) for c in np.unravel_index(rank,
                                                             self.shape))
        # what the sharding rules read of a Mesh: names and devices.shape
        self.devices = types.SimpleNamespace(shape=self.shape)
        self.groups = dict(groups or {})
        for a, n in zip(self.axis_names, self.shape):
            if n > 1 and self.groups.get(a) is None:
                raise ValueError(f"axis {a!r} of size {n} needs a group")
        self.collectives: collections.Counter = collections.Counter()
        # slots the expert-parallel MoE dispatch dropped on this rank (a
        # device scalar once it has run: read it after a step)
        self.moe_dropped = 0

    @classmethod
    def build(cls, store, axis_names, shape, rank, device,
              timeout=datetime.timedelta(seconds=120)) -> "RankMesh":
        """The mesh with one gloo group per axis line through ``rank``,
        over ``store`` (each line under its own prefix). Every rank of
        the mesh must build it at the same time: a group forms when all
        of its ranks have joined."""
        shape = tuple(shape)
        coords = np.unravel_index(rank, shape)
        groups = {}
        for i, (a, n) in enumerate(zip(axis_names, shape)):
            if n == 1:
                continue
            line = "-".join(str(int(c)) for j, c in enumerate(coords)
                            if j != i)
            groups[a] = dist.ProcessGroupGloo(
                dist.PrefixStore(f"{a}/{line}", store), int(coords[i]), n,
                timeout)
        return cls(axis_names, shape, rank, device, groups)

    # ------------------------------------------------------------ geometry
    def axis_size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self._axis(name)]

    def _axis(self, name):
        if name not in self.axis_names:
            raise ValueError(f"no mesh axis {name!r} in {self.axis_names}")
        return self.axis_names.index(name)

    def axes_size(self, axes) -> int:
        """The product of the sizes of ``axes``: an axis name, a tuple of
        them, or None (1)."""
        return int(np.prod([self.axis_size(a) for a in _names(axes)]))

    def axes_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (the shard of a
        dimension split over them, first axis major)."""
        i = 0
        for a in _names(axes):
            i = i * self.axis_size(a) + self.axis_index(a)
        return i

    # --------------------------------------------------------- collectives
    def _reduce(self, kind, axis, t, op=dist.ReduceOp.SUM):
        """All-reduce ``t`` in place over ``axis`` (counted as ``kind``);
        ``t`` itself on a size-1 axis."""
        if self.axis_size(axis) == 1:
            return t
        pg = self.groups[axis]
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        staged = self.device.type == "cuda" and pg.name() == "gloo"
        self.collectives[kind] += 1
        INS.collective(lambda: pg.allreduce([t], opts).wait(), staged=staged)
        return t

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over ``axis`` (a new tensor)."""
        return self._reduce("all-reduce", axis, x.contiguous().clone())

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise max of ``x`` over ``axis`` (a new tensor)."""
        return self._reduce("all-reduce", axis, x.contiguous().clone(),
                            dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The shards of ``axis`` concatenated along ``dim`` in axis
        order: an all-reduce of a zero-filled full buffer into which each
        rank has written its own shard."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        dim = dim % x.dim()
        shape = list(x.shape)
        w = shape[dim]
        shape[dim] = n * w
        buf = x.new_zeros(shape)
        i = self.axis_index(axis)
        buf.narrow(dim, i * w, w).copy_(x)
        return self._reduce("all-gather", axis, buf)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` [n, ...] holds one row per destination along ``axis``;
        returns [n, ...] with row s from source s (``jax.lax.all_to_all``
        with split and concat axis 0, untiled): an all-reduce of a
        zero-filled [n_src, n_dest, ...] buffer where this rank writes
        row ``[me]``, then reads column ``[:, me]``."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {axis!r} of size {n} needs "
                             f"{n} rows, got {tuple(x.shape)}")
        i = self.axis_index(axis)
        buf = x.new_zeros((n, *x.shape))
        buf[i] = x
        return self._reduce("all-to-all", axis, buf)[:, i].contiguous()


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
