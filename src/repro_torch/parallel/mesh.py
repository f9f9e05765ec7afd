"""The port's device mesh: this rank's place on named axes, and the
collectives of one axis line, differentiable.

Counterpart of the ``jax.sharding.Mesh`` the reference's sharded steps
run on. The reference is one controller over every device: GSPMD and
``shard_map`` insert the collectives, and ``jax.grad`` transposes them.
Here every rank runs the same program on its own shard and calls them
itself:

* ``RankMesh(axis_names, shape, rank, device, groups)``: ``rank`` is the
  row-major index into ``shape`` (the reference's ``mesh.devices``
  layout); ``groups`` maps each axis of size > 1 to the process group of
  the ranks that share every other coordinate with this one (this rank's
  line along the axis). A size-1 axis has no group, and its collectives
  return their input. ``RankMesh.build`` makes those groups as
  ``ProcessGroupNCCL(PrefixStore(f"{axis}/{line}", store), i, n, ...)``
  where each rank has a card of its own, and as ``ProcessGroupGloo``
  over the same stores where the ranks share a card or run on the CPU
  (``backend_for``: the ranks publish their devices on the store).
  ``RankMesh.dry`` is rank 0's view of a mesh with no group at all: its
  collectives record their kind and bytes and return tensors of the
  right shape without reducing, so a step runs on meta tensors
  (``launch/dryrun.py``).
* ``axis_names``, ``shape``, ``devices.shape``, ``axis_size``,
  ``axis_index`` and ``coords``: what ``parallel.sharding`` reads, as the
  reference reads a ``Mesh``.
* ``psum`` / ``pmax`` / ``all_gather`` / ``all_to_all`` over one axis,
  and ``enter`` (the identity, whose backward is a ``psum``). Each
  collective is counted on ``collectives`` by the reference's HLO name
  (``all-reduce``, ``all-gather``, ``all-to-all``, ``reduce-scatter``;
  ``pmax`` is an all-reduce there too), and by phase on ``tally()``:
  ``forward`` (a recomputed forward under remat counts again),
  ``backward`` (the conjugates below) and ``update`` (the train step's
  gradient sums and norm, ``psum_``). Only ``allreduce`` is called, the
  one collective both gloo and NCCL take for CUDA tensors with every op
  here: the gather and the all-to-all are all-reduces of zero-filled
  buffers with one writer per element, which is exact. ``pmax`` reduces
  with MAX. Nothing falls back: a collective that fails raises.
* ``kind_seconds``: the time in collectives by (phase, kind) since
  ``reset_tally``, and ``seconds`` the same by phase. A gloo collective
  stages through the host and waits for its result, so the host clock
  around it times it, always. An NCCL collective's ``wait()`` only
  orders the current stream after it, so it is timed on the device by
  two CUDA events on that stream, and only where the caller asked:
  ``reset_tally(timing=True)`` opens the window, reading the seconds
  (a host sync: read them after the step) closes it, and no event is
  recorded inside a CUDA-graph capture.

Gradients (``torch.autograd``) follow one convention, Megatron's: a
tensor that is the same on every rank of an axis (replicated) carries
the WHOLE cotangent on every rank of it. So:

* ``psum(grad="identity")`` (the default): the output is replicated and
  each rank's cotangent is already the whole one; it passes through. The
  row-parallel sums (``wo``, ``w_down``) and the vocab-split embedding.
* ``all_gather(grad="slice")`` (the default): each rank keeps its own
  slice of the whole cotangent. The vocab-split logits.
* ``enter``: where a replicated tensor enters a computation split over
  the axis (column-parallel q/k/v and ``w_gate`` / ``w_up``, the
  vocab-split ``lm_head``, the experts' ``d_ff`` slices, K/V heads that
  stay whole under split query heads), each rank's cotangent is a
  partial sum, and the backward sums them: identity forward, ``psum``
  backward.
* Where the ranks of an axis hold different rows (a batch axis) and a
  replicated result is sliced per rank afterwards, its cotangent differs
  per rank: ``psum(grad="psum")`` and ``all_gather(grad="reduce_scatter")``
  (a psum, then this rank's slice) sum them. The MoE dispatch under
  rules (``models/moe.py`` ``_routed_split``) gathers the batch's rows,
  sums the experts over ``data`` and keeps its rows; these are its two.
* ``all_to_all``'s backward is the inverse all-to-all, itself.
* ``pmax`` (flash-decoding, which training never reaches) has no
  backward: it raises.

Every backward clones before it reduces, as every forward does: the
all-reduce is in place. Every rank must run the same collectives in the
same order, backward too; the same program on every rank builds the
same autograd graph.

Every group is explicit, never the default one, so ranks can be threads
of one process (the CPU tests) or one process per card; ranks that
share a card take gloo (NCCL refuses two ranks on one device), ranks
with a card each take NCCL, and a mesh that mixes the two raises. On
the card two ranks must be processes: CUDA autograd runs one worker
thread per device, so two thread-ranks' backward collectives would wait
on each other in it. An NCCL group that fails raises; nothing drops
back to gloo.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import time
import types
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.serving import instrument as INS

PHASES = ("forward", "backward", "update")


class RankMesh:
    """One rank's view of a mesh ``shape`` over ``axis_names``."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int, device, groups: Optional[Dict[str, object]]
                 = None, *, dry: bool = False):
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
        self.is_dry = dry
        for a, n in zip(self.axis_names, self.shape):
            if n > 1 and not dry and self.groups.get(a) is None:
                raise ValueError(f"axis {a!r} of size {n} needs a group")
        self.collectives: collections.Counter = collections.Counter()
        self.reset_tally()
        # slots the expert-parallel MoE dispatch dropped on this rank (a
        # device scalar once it has run: read it after a step)
        self.moe_dropped = 0

    @classmethod
    def build(cls, store, axis_names, shape, rank, device,
              timeout=datetime.timedelta(seconds=120)) -> "RankMesh":
        """The mesh with one process group per axis line through
        ``rank``, over ``store`` (each line under its own prefix), of the
        backend ``backend_for`` picks from every rank's device. Every
        rank of the mesh must build it at the same time, over a store of
        its own (a fresh prefix): a group forms when all of its ranks
        have joined."""
        shape = tuple(shape)
        coords = np.unravel_index(rank, shape)
        backend = backend_for(rank_devices(store, rank, int(np.prod(shape)),
                                           device))
        groups = {}
        for i, (a, n) in enumerate(zip(axis_names, shape)):
            if n == 1:
                continue
            line = "-".join(str(int(c)) for j, c in enumerate(coords)
                            if j != i)
            groups[a] = new_group(backend,
                                  dist.PrefixStore(f"{a}/{line}", store),
                                  int(coords[i]), n, timeout)
        return cls(axis_names, shape, rank, device, groups)

    @classmethod
    def dry(cls, axis_names, shape, rank: int = 0,
            device="meta") -> "RankMesh":
        """``rank``'s view of a mesh with no groups: its collectives are
        counted (kind, bytes, phase) and return tensors of the right
        shape, unreduced (on meta tensors, nothing is allocated)."""
        return cls(axis_names, shape, rank, device, dry=True)

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

    # ---------------------------------------------------------------- tally
    def reset_tally(self, timing: bool = False):
        """Zero the per-phase counts, bytes and seconds (``tally``,
        ``kind_seconds``); ``collectives`` keeps counting. ``timing``:
        NCCL collectives are timed until the seconds are next read
        (module docstring)."""
        self._tally = {ph: {"count": collections.Counter(),
                            "bytes": collections.Counter()}
                       for ph in PHASES}
        self._seconds = collections.Counter()
        self._events = []
        self._timing = timing

    @property
    def kind_seconds(self) -> collections.Counter:
        """Seconds in collectives by (phase, kind) since ``reset_tally``;
        reading them waits for the NCCL ones timed so far and ends the
        timing window."""
        for key, start, end in self._events:
            end.synchronize()
            self._seconds[key] += start.elapsed_time(end) / 1e3
        self._events.clear()
        self._timing = False
        return self._seconds

    @property
    def seconds(self) -> collections.Counter:
        """``kind_seconds`` summed by phase."""
        out = collections.Counter()
        for (phase, _), s in self.kind_seconds.items():
            out[phase] += s
        return out

    @contextlib.contextmanager
    def _timed(self, key, nccl: bool):
        """Times the block into ``kind_seconds[key]``: the host clock on
        gloo, two CUDA events on NCCL inside a timing window."""
        if not nccl:
            t0 = time.perf_counter()
            yield
            self._seconds[key] += time.perf_counter() - t0
        elif self._timing and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((key, start, end))
        else:
            yield

    def tally(self) -> dict:
        """``{phase: {kind: {"count", "bytes"}}}`` since ``reset_tally``
        (phases: ``forward``, ``backward``, ``update``)."""
        return {ph: {k: {"count": t["count"][k], "bytes": t["bytes"][k]}
                     for k in sorted(t["count"])}
                for ph, t in self._tally.items()}

    # --------------------------------------------------------- collectives
    def _reduce(self, kind, axis, t, op=dist.ReduceOp.SUM, phase="forward"):
        """All-reduce ``t`` in place over ``axis`` (counted as ``kind`` in
        ``phase``); ``t`` itself on a size-1 axis. A dry mesh counts and
        returns ``t`` as it is."""
        if self.axis_size(axis) == 1:
            return t
        self.collectives[kind] += 1
        self._tally[phase]["count"][kind] += 1
        self._tally[phase]["bytes"][kind] += t.numel() * t.element_size()
        if self.is_dry:
            return t
        pg = self.groups[axis]
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        nccl = pg.name() == "nccl"
        staged = self.device.type == "cuda" and not nccl
        with self._timed((phase, kind), nccl):
            INS.collective(lambda: pg.allreduce([t], opts).wait(),
                           staged=staged)
        return t

    def psum(self, x: torch.Tensor, axis: str, grad: str = "identity"
             ) -> torch.Tensor:
        """The sum of ``x`` over ``axis`` (a new tensor where the axis has
        more than one rank). Its backward is
        the identity, or with ``grad="psum"`` a psum (module
        docstring)."""
        if self.axis_size(axis) == 1:
            return x
        if grad not in ("identity", "psum"):
            raise ValueError(f"psum's backward is 'identity' or 'psum', "
                             f"not {grad!r}")
        return _Psum.apply(x, self, axis, grad)

    def psum_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` summed over ``axis`` IN PLACE, outside autograd, counted
        in the ``update`` phase (the train step's gradient sums and its
        norm)."""
        return self._reduce("all-reduce", axis, t, phase="update")

    def enter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` itself, whose cotangent is summed over ``axis`` in the
        backward: where a tensor replicated over ``axis`` enters a
        computation split over it (module docstring)."""
        if self.axis_size(axis) == 1 or not (torch.is_grad_enabled()
                                             and x.requires_grad):
            return x
        return _Enter.apply(x, self, axis)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise max of ``x`` over ``axis`` (a new tensor); no
        backward."""
        if self.axis_size(axis) == 1:
            return x
        return _Pmax.apply(x, self, axis)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int,
                   grad: str = "slice") -> torch.Tensor:
        """The shards of ``axis`` concatenated along ``dim`` in axis
        order: an all-reduce of a zero-filled full buffer into which each
        rank has written its own shard. Its backward keeps this rank's
        slice of the cotangent, or with ``grad="reduce_scatter"`` of its
        sum over ``axis`` (module docstring)."""
        if self.axis_size(axis) == 1:
            return x
        if grad not in ("slice", "reduce_scatter"):
            raise ValueError(f"all_gather's backward is 'slice' or "
                             f"'reduce_scatter', not {grad!r}")
        return _AllGather.apply(x, self, axis, dim % x.dim(), grad)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` [n, ...] holds one row per destination along ``axis``;
        returns [n, ...] with row s from source s (``jax.lax.all_to_all``
        with split and concat axis 0, untiled): an all-reduce of a
        zero-filled [n_src, n_dest, ...] buffer where this rank writes
        row ``[me]``, then reads column ``[:, me]``. Its backward is the
        same all-to-all of the cotangent (its own inverse)."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {axis!r} of size {n} needs "
                             f"{n} rows, got {tuple(x.shape)}")
        return _AllToAll.apply(x, self, axis)

    # the collectives themselves, on tensors outside autograd
    def _gather(self, x, axis, dim, kind="all-gather", phase="forward"):
        n, i = self.axis_size(axis), self.axis_index(axis)
        shape = list(x.shape)
        w = shape[dim]
        shape[dim] = n * w
        buf = x.new_zeros(shape)
        buf.narrow(dim, i * w, w).copy_(x)
        return self._reduce(kind, axis, buf, phase=phase)

    def _a2a(self, x, axis, phase="forward"):
        n, i = self.axis_size(axis), self.axis_index(axis)
        buf = x.new_zeros((n, *x.shape))
        buf[i] = x
        return self._reduce("all-to-all", axis, buf,
                            phase=phase)[:, i].contiguous()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, grad):
        ctx.mesh, ctx.axis, ctx.grad = mesh, axis, grad
        return mesh._reduce("all-reduce", axis, x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "psum":
            g = ctx.mesh._reduce("all-reduce", ctx.axis,
                                 g.contiguous().clone(), phase="backward")
        return g, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._reduce("all-reduce", ctx.axis,
                                 g.contiguous().clone(), phase="backward"),
                None, None)


class _Pmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh._reduce("all-reduce", axis, x.contiguous().clone(),
                            dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "pmax has no backward: it combines flash-decoding's partials, "
            "which only serving runs")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad = mesh, axis, dim, grad
        ctx.w = x.shape[dim]
        return mesh._gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if ctx.grad == "reduce_scatter":
            g = mesh._reduce("reduce-scatter", ctx.axis,
                             g.contiguous().clone(), phase="backward")
        i = mesh.axis_index(ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.w, ctx.w).contiguous(),
                None, None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._a2a(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._a2a(g.contiguous(), ctx.axis, phase="backward"), \
            None, None


def explicit_device(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` names the current
    card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def backend_for(devices) -> str:
    """The backend of ranks on ``devices`` (one per rank): ``"nccl"``
    where each rank has a card of its own, ``"gloo"`` where they all
    share one card (NCCL refuses two ranks on one device) or all run on
    the CPU. Any other mix raises."""
    devs = [explicit_device(d) for d in devices]
    kinds = {d.type for d in devs}
    cards = {d.index for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds == {"cuda"} and len(cards) == len(devs):
        return "nccl"
    if kinds == {"cuda"} and len(cards) == 1:
        return "gloo"
    raise ValueError(f"ranks on {[str(d) for d in devs]}: neither one card "
                     f"each (NCCL) nor all on one card or the CPU (gloo)")


def rank_devices(store, rank: int, size: int, device) -> list:
    """Every rank's device, in rank order: each of the ``size`` ranks
    publishes its own on ``store`` and reads the others' (waiting for
    them)."""
    store.set(f"device/{rank}", str(explicit_device(device)))
    return [torch.device(store.get(f"device/{q}").decode())
            for q in range(size)]


def new_group(backend: str, store, rank: int, size: int, timeout):
    """A process group of ``size`` ranks over ``store``: NCCL (this
    rank's tensors on its current card) or gloo, as ``backend`` says."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    return dist.ProcessGroupGloo(store, rank, size, timeout)


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
