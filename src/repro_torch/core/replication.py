"""Module replication (§3.1) across the ranks of a ``torch.distributed``
process group.

Counterpart of ``repro.core.replication``. The reference is one
controller driving every device of a mesh: a plan's per-layer degree
becomes a batch-sharding constraint over a factorized replication mesh
(axes ``r0, r1, ...`` of size 2), and GSPMD inserts the scatter and the
all-gather the paper describes. Here every rank runs the same program on
its own process, and the hooks run those collectives themselves:

* ``ReplicationGroup`` is the mesh: a process group of power-of-two size
  W, this process's rank and its device. Axis ``r0`` is the most
  significant bit of the rank, as the reference's ``reshape((2,)*k)``.
  ``default_replication_group`` is the size-1 group: without a group
  every degree quantizes to 1, whatever number of cards is visible.
* ``batch_shard_for_degree``: at degree d the batch is split d ways over
  the first log2(d) axes, so rank r computes shard ``r // (W // d)``
  and the W // d ranks that share a shard compute it alike.
* ``LayerHook`` (``layer_hook_from_degrees`` / ``layer_hook_from_plan``)
  is what ``forward`` and ``forward_paged`` call around each layer:
  before layer i it hands on this rank's rows at layer i's degree (the
  scatter is a local slice); on leaving a replicated region, or at a
  change of degree, it gathers the full batch. Consecutive layers of one
  degree stay split, as GSPMD leaves them. A batch the degree does not
  divide is padded, as GSPMD pads an uneven shard.
* ``count_collectives``: where the reference parses HLO, the port counts
  the collectives its hooks run, by kind, on the group's counter.
* ``replicate_params_for_plan``: rank 0's parameters broadcast to every
  rank, so every replica owns a copy (the paper's memory accounting).

Every function takes an explicit group, never the default one, so ranks
can be threads of one process (the CPU tests) or one process per card.
``ReplicationGroup.build`` picks the backend from where the ranks lie
(``parallel.mesh.backend_for``): NCCL where each rank has its own card,
gloo where ranks share a card or run on the CPU; ``ReplicationGroup.of``
wraps a process group the caller made. An NCCL group's collectives run
on the card, so a CUDA graph can hold them (``capturable``); gloo's
stage through the host (``staged``). Only the collectives
both accept for CUDA tensors are used (``all_reduce``, ``broadcast``
and ``alltoall_base`` with uneven splits, the last for
``core.migration``'s re-placement): the all-gather is an all-reduce of
a zero-filled full buffer into which one rank of each shard has written
its rows, which is exact (each element sums one value and zeros) and the
same on every rank. Nothing falls back: a collective that fails raises.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import mesh as M
from repro_torch.serving import instrument as INS


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def axis_names(size: int) -> Tuple[str, ...]:
    """``r0 .. r{k-1}`` for 2**k ranks; one axis ``r0`` of size 1 for one
    rank, as the reference's one-device mesh."""
    k = int(math.log2(size))
    return tuple(f"r{i}" for i in range(max(k, 1)))


def axis_index(rank: int, size: int, name: str) -> int:
    """``rank``'s coordinate on axis ``name`` of a group of ``size`` ranks
    (r0: the top bit; 0 in a group of one)."""
    if name not in axis_names(size):
        raise ValueError(f"no replication axis {name!r} in "
                         f"{axis_names(size)}")
    k = int(math.log2(size))
    return (rank >> (k - 1 - int(name[1:]))) & 1 if k else 0


@dataclasses.dataclass(eq=False)
class ReplicationGroup:
    """W ranks (a power of two) that replicate layers between them, the
    port's mesh of axes ``r0 .. r{k-1}``. ``pg`` is the
    ``torch.distributed`` process group (None for the size-1 group);
    ``counts`` the collectives run so far, by the reference's names
    (``count_collectives``); ``bytes_received`` the bytes this rank's
    all-to-alls (re-placement) brought in from the other ranks.

    Ranks that are threads of one process on the CPU share its MKL: set
    ``MKL_CBWR=COMPATIBLE`` before the process's first GEMM, or two ranks
    may now and then compute the same rows with other bits (ROADMAP C8;
    ``examples/torch_migrate_modules.py`` and the port's tests set it)."""
    pg: Optional[object]
    rank: int
    size: int
    device: torch.device
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes_received: int = 0

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.size < 1 or self.size & (self.size - 1):
            raise ValueError(f"a replication group needs a power-of-two "
                             f"size, got {self.size}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a group of "
                             f"{self.size}")
        if self.size > 1 and self.pg is None:
            raise ValueError("a group of several ranks needs a process "
                             "group")

    @classmethod
    def of(cls, pg, device) -> "ReplicationGroup":
        """The group over ``pg`` (a ProcessGroup or a backend such as
        ``ProcessGroupGloo``), this rank's tensors on ``device``."""
        return cls(pg, pg.rank(), pg.size(), device)

    @classmethod
    def build(cls, store, rank: int, size: int, device,
              timeout=datetime.timedelta(seconds=120)) -> "ReplicationGroup":
        """The group of ``size`` ranks over ``store``, this rank's
        tensors on ``device``: NCCL where each rank has a card of its own
        (each process calls ``torch.cuda.set_device`` to its card first),
        gloo where they share one or run on the CPU
        (``parallel.mesh.backend_for``; the ranks publish their devices
        on ``store``). Every rank calls it at the same time, over a store
        of its own (a fresh prefix); a failing NCCL group raises."""
        backend = M.backend_for(M.rank_devices(store, rank, size, device))
        pg = (M.new_group(backend, dist.PrefixStore("pg", store), rank,
                          size, timeout) if size > 1 else None)
        return cls(pg, rank, size, device)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return axis_names(self.size)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (r0: the top bit)."""
        return axis_index(self.rank, self.size, name)

    @property
    def staged(self) -> bool:
        """Whether a collective stages through the host: gloo on CUDA
        tensors copies them to host memory and back."""
        return (self.pg is not None and self.device.type == "cuda"
                and self.pg.name() == "gloo")

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this group's collectives: NCCL
        runs them on the card; gloo stages them through the host. A group
        of one rank runs none."""
        return self.pg is None or self.pg.name() == "nccl"

    def _run(self, kind: str, op):
        self.counts[kind] += 1
        INS.collective(op, staged=self.staged)

    def all_reduce(self, t: torch.Tensor, kind: str = "all-reduce"):
        """Sum ``t`` over the group in place (counted as ``kind``)."""
        if self.size > 1:
            self._run(kind, lambda: self.pg.allreduce([t]).wait())
        return t

    def broadcast(self, t: torch.Tensor):
        """``t`` in place := rank 0's ``t``."""
        if self.size > 1:
            if not t.is_contiguous():
                raise ValueError("broadcast needs a contiguous tensor")
            opts = dist.BroadcastOptions()
            opts.rootRank = 0
            self._run("broadcast", lambda: self.pg.broadcast([t], opts).wait())
        return t

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor,
                   out_splits: Sequence[int], in_splits: Sequence[int]):
        """One exchange of pieces of uneven size between every pair of
        ranks: ``inp`` holds, in rank order, ``in_splits[q]`` elements
        for each rank q; ``out`` receives, in rank order,
        ``out_splits[q]`` elements from each rank q. Counted as
        ``all-to-all``; ``out``'s bytes add to ``bytes_received``."""
        if self.size > 1:
            self.bytes_received += out.numel() * out.element_size()
            self._run("all-to-all", lambda: self.pg.alltoall_base(
                out, inp, list(out_splits), list(in_splits),
                dist.AllToAllOptions()).wait())
        return out


def same_device(a, b) -> bool:
    """Whether two device names are one device: a bare ``"cuda"`` names
    the current card, so it equals ``"cuda:<current index>"``."""
    return M.explicit_device(a) == M.explicit_device(b)


def default_replication_group(device="cpu") -> ReplicationGroup:
    """The group an engine replicates over when it is given none: this
    process alone, where every degree quantizes to 1."""
    return ReplicationGroup(None, 0, 1, device)


def quantize_degrees(p: Sequence[int], n_devices: int) -> List[int]:
    """Round each p_i down to the nearest power of two <= n_devices."""
    out = []
    for pi in p:
        q = 1
        while q * 2 <= min(pi, n_devices):
            q *= 2
        out.append(q)
    return out


def batch_shard_for_degree(degree: int, group: ReplicationGroup
                           ) -> Tuple[int, int]:
    """(shard, of): the shard of a batch split ``degree`` ways over the
    group's first log2(degree) axes that this rank computes — the
    reference's ``batch_spec_for_degree`` seen from one rank."""
    d = min(degree, group.size)
    if d < 1 or d & (d - 1):
        raise ValueError(f"degree {degree} is not a power of two")
    return group.rank // (group.size // d), d


class LayerHook:
    """``hook(i, x)`` -> this rank's rows of x ``[B, ...]`` at layer i's
    degree; ``hook.full(x)`` -> the full batch again. The forward calls
    ``hook(i, x)`` before each layer (i = 0 starts a call) and
    ``hook.full`` after the last; in between, ``rows`` gives this rank's
    rows of any other per-row operand at the current degree and
    ``gather_kv`` a paged layer's full-batch K/V rows. Gathers are
    counted as ``all-gather``, the reference's HLO name."""

    def __init__(self, degrees: Sequence[int], group: ReplicationGroup):
        self.degrees = tuple(min(d, group.size) for d in degrees)
        self.group = group
        self.degree = 1        # the split that x is in now
        self.batch = 0         # B, the full batch

    def __call__(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if i == 0:
            self.degree, self.batch = 1, x.shape[0]
        d = self.degrees[i]
        if d == self.degree:
            return x
        x = self.full(x)
        self.degree = d
        return self._slice(x, d, 0)

    def full(self, x: torch.Tensor) -> torch.Tensor:
        """The full batch of a split x (an all-gather); x itself at
        degree 1. The next layer's hook call splits again."""
        if self.degree > 1:
            x = self._gather(x)
            self.degree = 1
        return x

    def rows(self, t, fill=0):
        """This rank's rows of a per-row operand (a tensor, a tuple of
        them, or None) at the current degree, padding rows set to
        ``fill``."""
        if t is None or self.degree == 1:
            return t
        if isinstance(t, tuple):
            return tuple(self.rows(u, fill) for u in t)
        return self._slice(t, self.degree, fill)

    def gather_kv(self, k: torch.Tensor, v: torch.Tensor):
        """A replicated paged layer's K/V rows [b, ...] of this rank ->
        every row's [B, ...], in one gather: every rank then writes every
        row, so each rank's pool stays a full replica."""
        kv = self._gather(torch.cat([k, v], dim=-1))
        return kv.split(k.shape[-1], dim=-1)

    def _slice(self, t, d, fill):
        s, _ = batch_shard_for_degree(d, self.group)
        b = -(-self.batch // d)
        out = t[s * b:(s + 1) * b]
        if out.shape[0] < b:    # an uneven shard: padding rows
            pad = t.new_full((b - out.shape[0], *t.shape[1:]), fill)
            out = torch.cat([out, pad])
        return out

    def _gather(self, t):
        d = self.degree
        s, _ = batch_shard_for_degree(d, self.group)
        b = t.shape[0]
        buf = t.new_zeros((d * b, *t.shape[1:]))
        if self.group.rank % (self.group.size // d) == 0:
            buf[s * b:(s + 1) * b] = t   # one writer per shard
        self.group.all_reduce(buf, "all-gather")
        return buf[:self.batch]


def layer_hook_from_degrees(degrees: Tuple[int, ...],
                            group: ReplicationGroup) -> LayerHook:
    """The hook of an already-quantized degree tuple (the engine's
    ``_step_degrees``)."""
    return LayerHook(degrees, group)


def layer_hook_from_plan(plan, group: ReplicationGroup) -> LayerHook:
    """The hook of a PlacementPlan's degrees, quantized to the group."""
    return LayerHook(quantize_degrees(plan.p, group.size), group)


@contextlib.contextmanager
def count_collectives(group: ReplicationGroup):
    """Yields a dict that holds, when the block ends, the collectives
    ``group`` ran inside it by kind (``all-gather``, ``broadcast``,
    ``all-reduce``, ``all-to-all``) — the reference's HLO histogram,
    counted as they run."""
    out: dict = {}
    before = collections.Counter(group.counts)
    try:
        yield out
    finally:
        out.update(group.counts - before)


def replicate_params_for_plan(params, group: ReplicationGroup):
    """Every rank's parameter tree := rank 0's, leaf by leaf in place (a
    broadcast): layer replication shares weights, and every replica owns
    a copy, as in the paper's Table 2. Returns ``params``."""
    return _tree_map(group.broadcast, params)
