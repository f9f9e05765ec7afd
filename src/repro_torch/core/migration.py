"""Module migration — re-placement of parameters / caches (§3.1, §3.3).

Counterpart of ``repro.core.migration``. The cost model (bytes moved /
link bandwidth + a fixed per-migration overhead) has the shape of the
paper's Table 2; ``fit_migration_model`` fits its two constants to the
host it runs on. ``migrate_blocks`` ships the unit CoCoServe's live
scale-down moves, one request's KV blocks between two engines' block
pools (the wire format of ``serving/paged_kv.export_blocks``).

``migrate_by_path`` re-places the leaves of a tree whose path matches a
regex across the ranks of a ``core.replication.ReplicationGroup``, as the
reference's ``jax.device_put`` under a ``NamedSharding`` does
(``migrate_kv_cache``: a dense cache's layers; ``migrate_paged_pool``: a
whole block pool, in place). The port's placement is a per-dimension
tuple, its own ``PartitionSpec``: each entry None (not split), an axis
name (``"r0"``) or a tuple of them, r0 the most significant; ``()`` is
replicated. A JAX array carries its sharding; here the placement of each
tensor ``migrate_by_path`` returns is recorded beside it
(``placement_of``), so the next re-placement starts from wherever the
leaf is: whole, replicated or split. A tensor with no record is whole on
rank 0, and every other rank holds a placeholder of the leaf whose values
are ignored: a whole-size tensor, or a tensor on the ``meta`` device
(shape and type only), which never allocates the whole leaf.

``replacement_plan``, a function of (global shape, source placement,
target placement, group size) alone, works out the block of the index
space each rank holds before and after, as
``NamedSharding.devices_indices_map`` does. A rank keeps what part of its
new block it already holds; every other part comes from one holder, the
one whose coordinates on the axes the source placement leaves unused are
0 (rank 0 for a tensor with no record). The pieces travel in one
``alltoall_base`` per leaf with uneven split sizes, which gloo (staged
through the host) and NCCL both take for CUDA tensors, and in none where
no rank lacks anything. A rank so receives only the part of its new block
it lacked (``ReplicationGroup.bytes_received``); ``bytes_moved`` is the
reference's ``tree_bytes`` of the matched leaves, their global size.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.utils.weak

from repro_torch.core import replication as R
from repro_torch.serving import instrument as INS
from repro_torch.serving import paged_kv as PK

_PATH_JOIN = "/"


@dataclasses.dataclass(frozen=True)
class MigrationCost:
    bytes_moved: int
    est_seconds: float          # bytes / link_bw + fixed overhead
    measured_seconds: Optional[float] = None


def _leaves(tree, prefix=()):
    """(path, leaf) over nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_bytes(tree, path_regex: str = ".*") -> int:
    """Bytes of every tensor (or numpy array) leaf of a nested dict whose
    '/'-joined key path matches ``path_regex``."""
    pat = re.compile(path_regex)
    total = 0
    for path, leaf in _leaves(tree):
        if not pat.search(_PATH_JOIN.join(path)):
            continue
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


def estimate_cost(bytes_moved: int, link_bandwidth: float,
                  fixed_overhead_s: float = 0.24) -> float:
    """Paper Table 2: ~0.25 s at 1 layer rising to ~0.9 s at 40 layers — a
    large fixed setup cost plus a linear bytes/bandwidth term. The
    defaults are the orchestrator's; ``fit_migration_model`` measures
    this host's own."""
    return fixed_overhead_s + bytes_moved / link_bandwidth


def _map_leaves(fn, tree, prefix=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


Block = Tuple[Tuple[int, int], ...]      # [start, stop) of each dim


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor ``migrate_by_path`` returned lies: ``spec`` (the
    normalized placement, one tuple of axis names per dimension) over a
    group of ``size`` ranks, of a leaf whose global shape is ``shape``."""
    spec: Tuple[Tuple[str, ...], ...]
    size: int
    shape: Tuple[int, ...]


_PLACEMENTS = torch.utils.weak.WeakIdKeyDictionary()


def placement_of(t: torch.Tensor) -> Optional[Placement]:
    """The placement recorded for ``t``; None where there is none: ``t``
    is then whole on rank 0 (or a placeholder of it on another rank)."""
    return _PLACEMENTS.get(t)


def _normalize(spec, ndim: int, size: int) -> Tuple[Tuple[str, ...], ...]:
    """``spec`` as one tuple of axis names per dimension, checked against
    the axes of a group of ``size`` ranks."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"placement {spec} has more entries than the "
                         f"{ndim} dims of the tensor")
    names = R.axis_names(size)
    out, seen = [], set()
    for axes in spec + (None,) * (ndim - len(spec)):
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        for a in axes:
            if a not in names:
                raise ValueError(f"no replication axis {a!r} in {names}")
            if a in seen:
                raise ValueError(f"axis {a!r} used twice in {spec}")
            seen.add(a)
        out.append(axes)
    return tuple(out)


def _blocks(shape, spec, size: int) -> Tuple[Block, ...]:
    """The block each of ``size`` ranks holds of a ``shape`` tensor under
    the normalized ``spec`` (``NamedSharding.devices_indices_map``)."""
    width = min(size, 2)
    out = []
    for rank in range(size):
        block = []
        for n_dim, axes in zip(shape, spec):
            n, idx = 1, 0
            for a in axes:
                n, idx = n * width, idx * width + R.axis_index(rank, size, a)
            if n_dim % n:
                raise ValueError(f"a dim of {tuple(shape)} does not split "
                                 f"{n} ways")
            step = n_dim // n
            block.append((idx * step, (idx + 1) * step))
        out.append(tuple(block))
    return tuple(out)


def _meet(a: Optional[Block], b: Block) -> Optional[Block]:
    if a is None:
        return None
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return None if any(x0 >= x1 for x0, x1 in out) else out


def _numel(block: Block) -> int:
    return math.prod(x1 - x0 for x0, x1 in block)


@dataclasses.dataclass(frozen=True)
class ReplacementPlan:
    """A leaf's re-placement over a group: the block each rank holds
    ``before`` (None: nothing) and ``after``, and the ``pieces`` that
    travel, each (sender, receiver, block of the global index space)."""
    before: Tuple[Optional[Block], ...]
    after: Tuple[Block, ...]
    pieces: Tuple[Tuple[int, int, Block], ...]

    def received(self, rank: int) -> int:
        """Elements ``rank`` receives from the other ranks."""
        return sum(_numel(b) for _, r, b in self.pieces if r == rank)


def replacement_plan(shape, src, dst, size: int) -> ReplacementPlan:
    """How a ``shape`` leaf moves from the placement ``src`` (a spec, or
    None for whole on rank 0) to ``dst`` over ``size`` ranks: a rank keeps
    the part of its new block it holds; each other part of it comes from
    the holder whose coordinates on the axes ``src`` does not use are 0."""
    shape = tuple(shape)
    dst = _normalize(dst, len(shape), size)
    whole = tuple((0, n) for n in shape)
    if src is None:
        before = (whole,) + (None,) * (size - 1)
        senders = [0]
    else:
        src = _normalize(src, len(shape), size)
        before = _blocks(shape, src, size)
        unused = set(R.axis_names(size)) - {a for axes in src for a in axes}
        senders = [r for r in range(size)
                   if not any(R.axis_index(r, size, a) for a in unused)]
    after = _blocks(shape, dst, size)
    pieces = []
    for r in range(size):
        for s in senders:
            if s == r or before[s] == before[r]:
                continue   # a part this rank holds itself
            part = _meet(before[s], after[r])
            if part is not None:
                pieces.append((s, r, part))
    return ReplacementPlan(before, after, tuple(pieces))


def _local(block: Block, within: Block):
    """Index of the global ``block`` in a tensor holding ``within``."""
    return tuple(slice(x0 - w0, x1 - w0) for (x0, x1), (w0, _) in zip(block, within))


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


def _plan(leaf: torch.Tensor, new_spec, size: int, rank: int):
    """(global shape, plan) of re-placing this rank's ``leaf`` from the
    placement it has under ``new_spec`` over ``size`` ranks."""
    rec = placement_of(leaf)
    if rec is None:
        shape = tuple(leaf.shape)
        return shape, replacement_plan(shape, None, new_spec, size)
    if rec.size != size:
        raise ValueError(f"a tensor placed over {rec.size} ranks re-placed "
                         f"over a group of {size}")
    plan = replacement_plan(rec.shape, rec.spec, new_spec, size)
    if tuple(leaf.shape) != tuple(b - a for a, b in plan.before[rank]):
        raise ValueError(f"a {tuple(leaf.shape)} tensor contradicts its "
                         f"placement {rec.spec} of a {rec.shape} leaf over "
                         f"{size} ranks")
    return rec.shape, plan


def planned_bytes(tree, path_regex: str, new_spec, size: int, rank: int) -> int:
    """The bytes ``rank`` receives when ``migrate_by_path`` re-places the
    leaves of its ``tree`` that match ``path_regex`` under ``new_spec``
    over ``size`` ranks (each leaf's ``replacement_plan``)."""
    pat = re.compile(path_regex)
    return sum(_plan(leaf, new_spec, size, rank)[1].received(rank)
               * leaf.element_size() for path, leaf in _leaves(tree)
               if pat.search(_PATH_JOIN.join(path)))


def _replace(leaf: torch.Tensor, new_spec, group) -> torch.Tensor:
    """This rank's tensor of ``leaf`` re-placed under ``new_spec``."""
    shape, plan = _plan(leaf, new_spec, group.size, group.rank)
    r = group.rank
    have, need = plan.before[r], plan.after[r]
    new_shape = tuple(b - a for a, b in need)
    device = group.device if leaf.device.type == "meta" else leaf.device
    if have == need:
        out = leaf                     # the whole new block is here already
    elif (have is None and leaf.device.type != "meta"
          and tuple(leaf.shape) == new_shape):
        out = leaf                     # a placeholder, received into in place
    else:
        out = torch.empty(new_shape, dtype=leaf.dtype, device=device)
        mine = _meet(have, need)
        if mine is not None:
            out[_local(mine, need)] = leaf[_local(mine, have)]
    if plan.pieces:           # one exchange, where some rank lacks a part
        incoming = {s: b for s, q, b in plan.pieces if q == r}
        outgoing = {q: b for s, q, b in plan.pieces if s == r}
        item = leaf.element_size()
        in_splits = [_numel(outgoing[q]) * item if q in outgoing else 0
                     for q in range(group.size)]
        out_splits = [_numel(incoming[q]) * item if q in incoming else 0
                      for q in range(group.size)]
        sends = [_as_bytes(leaf[_local(outgoing[q], have)])
                 for q in sorted(outgoing)]
        send = (torch.cat(sends) if len(sends) > 1 else sends[0] if sends
                else torch.empty(0, dtype=torch.uint8, device=device))
        direct = list(incoming.values()) == [need] and out.is_contiguous()
        recv = (out.view(-1).view(torch.uint8) if direct else
                torch.empty(sum(out_splits), dtype=torch.uint8, device=device))
        group.all_to_all(recv, send, out_splits, in_splits)
        if not direct:
            offsets = list(itertools.accumulate([0] + out_splits))
            for s, b in incoming.items():
                piece = recv[offsets[s]:offsets[s + 1]]
                out[_local(b, need)] = piece.view(leaf.dtype).view(
                    tuple(x1 - x0 for x0, x1 in b))
    if group.size > 1:
        _PLACEMENTS[out] = Placement(_normalize(new_spec, len(shape), group.size),
                                     group.size, shape)
    return out


def migrate_by_path(tree, path_regex: str, new_spec, group, *,
                    link_bandwidth: float = 50e9, measure: bool = False):
    """Re-place every leaf whose '/'-joined path matches ``path_regex``
    under ``new_spec`` over ``group`` (module docstring), from the
    placement it has (``placement_of``; whole on rank 0 where it has
    none): each rank receives only the part of its new block it lacks,
    in one all-to-all per leaf or none. The new tree holds this rank's
    block of each such leaf: the tensor itself where it held that block
    already (its storage kept), a placeholder received into in place, or
    a new tensor with storage of its own; other leaves are kept.
    ``bytes_moved`` counts the matched leaves whole (``tree_bytes``).
    Returns (new_tree, MigrationCost)."""
    pat = re.compile(path_regex)
    moved = 0

    def place(path, leaf):
        nonlocal moved
        if not pat.search(_PATH_JOIN.join(path)):
            return leaf
        rec = placement_of(leaf)
        moved += math.prod(rec.shape if rec else leaf.shape) * leaf.element_size()
        return _replace(leaf, new_spec, group)

    t0 = time.perf_counter()
    new_tree = _map_leaves(place, tree)
    if measure:
        INS.synchronize(group.device)
    dt = time.perf_counter() - t0 if measure else None
    return new_tree, MigrationCost(moved, estimate_cost(moved, link_bandwidth),
                                   dt)


def migrate_kv_cache(cache, new_spec, group, **kw):
    """KV-cache migration (the paper's memory-intensive module, §3.3)."""
    return migrate_by_path(cache, r"layers/", new_spec, group, **kw)


def migrate_paged_pool(state, new_spec, group, **kw):
    """Re-place a whole paged block pool (``paged_kv.PagedState``).
    Mutates ``state`` in place: under a replicated placement its K/V
    tensors keep their addresses, so an engine (and its graphs) keeps
    serving from the pool; returns (state, MigrationCost)."""
    handle = {"k": state.k, "v": state.v}
    new, cost = migrate_by_path(handle, r"^(k|v)$", new_spec, group, **kw)
    state.k, state.v = new["k"], new["v"]
    return state, cost


def _resolve_device(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to probe "
                           "migrations on the CPU")
    return torch.device("cuda")


def probe_block_migration(cfg, n_tokens: int, *, block_size: int = 8,
                          repeats: int = 5, dtype="float32", device=None):
    """Measure one request-sized block migration between two fresh pools
    on ``device``: returns (median seconds, bytes moved). The
    micro-probe behind ``fit_migration_model``."""
    device = _resolve_device(device)
    times, nbytes = [], 0
    L, KVh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    n_blocks = 2 * (-(-n_tokens // block_size)) + 2
    for _ in range(repeats):
        src = PK.init_paged(cfg, 2, n_blocks, block_size=block_size,
                            dtype=dtype, max_len=n_tokens + block_size,
                            device=device)
        dst = PK.init_paged(cfg, 2, n_blocks, block_size=block_size,
                            dtype=dtype, max_len=n_tokens + block_size,
                            device=device)
        kv = torch.zeros((L, n_tokens, KVh, hd), device=device)
        PK.allocate(src, 0, n_tokens)
        PK.write_tokens(src, 0, kv, kv)
        INS.synchronize(device)
        _, cost = migrate_blocks(src, dst, 0, 0, measure=True)
        times.append(cost.measured_seconds)
        nbytes = cost.bytes_moved
    times.sort()
    return times[len(times) // 2], nbytes


def fit_migration_model(cfg, *, block_size: int = 8, small_tokens: int = 16,
                        large_tokens: int = 512, repeats: int = 5,
                        dtype="float32", device=None):
    """Calibrate ``estimate_cost``'s two constants — fixed overhead and
    effective bandwidth — from two probe block-migrations on THIS host's
    ``device``, as the paper fits Table 2 to its testbed. Returns a dict
    with the fit plus the raw probes."""
    t_small, b_small = probe_block_migration(
        cfg, small_tokens, block_size=block_size, repeats=repeats,
        dtype=dtype, device=device)
    t_large, b_large = probe_block_migration(
        cfg, large_tokens, block_size=block_size, repeats=repeats,
        dtype=dtype, device=device)
    if t_large > t_small and b_large > b_small:
        bw = (b_large - b_small) / (t_large - t_small)
    else:  # timer noise floor: overhead dominates, bandwidth unresolvable
        bw = 1e12
    overhead = max(t_small - b_small / bw, 1e-6)
    return {"fixed_overhead_s": overhead, "bandwidth_Bps": bw,
            "probe_small": {"bytes": b_small, "seconds": t_small},
            "probe_large": {"bytes": b_large, "seconds": t_large}}


def migrate_blocks(src_state, dst_state, src_slot: int, dst_slot: int, *,
                   link_bandwidth: float = 50e9,
                   fixed_overhead_s: float = 0.24,
                   measure: bool = False, wire: str = "bits"):
    """Block-granular migration of ONE live request between two engines'
    pools (CoCoServe scale-down / rebalance): export the request's blocks
    from ``src_state`` (serving/paged_kv.export_blocks wire format), bind
    them into ``dst_state`` at the same block-table columns (absolute
    positions, and so RoPE, window masking and counter-based sampling
    replay, are preserved), then release them at the source. Shared
    source blocks are materialized by the wire format itself.

    ``measure=True`` waits for the destination's device before reading
    the clock. ``wire`` is ``export_blocks``' choice for the payload
    (``"float32"`` for a destination that reads arrays by value); the
    cost counts the bytes shipped. Returns (payload, MigrationCost). Raises
    paged_kv.OutOfBlocks without touching the source when the
    destination can't hold the payload."""
    t0 = time.perf_counter()
    payload = PK.export_blocks(src_state, src_slot, wire=wire)
    PK.import_blocks(dst_state, dst_slot, payload)   # raises before mutation
    PK.free_slot(src_state, src_slot)
    if measure:
        INS.synchronize(dst_state.k.device)
    dt = time.perf_counter() - t0 if measure else None
    cost = MigrationCost(payload["nbytes"],
                         estimate_cost(payload["nbytes"], link_bandwidth,
                                       fixed_overhead_s),
                         dt)
    return payload, cost
