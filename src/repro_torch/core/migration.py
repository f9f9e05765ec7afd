"""Module migration — re-placement of parameters / caches (§3.1, §3.3).

Counterpart of ``repro.core.migration``. The cost model (bytes moved /
link bandwidth + a fixed per-migration overhead) has the shape of the
paper's Table 2; ``fit_migration_model`` fits its two constants to the
host it runs on. ``migrate_blocks`` ships the unit CoCoServe's live
scale-down moves, one request's KV blocks between two engines' block
pools (the wire format of ``serving/paged_kv.export_blocks``).

``migrate_by_path`` re-places the leaves of a tree whose path matches a
regex across the ranks of a ``core.replication.ReplicationGroup``
(``migrate_kv_cache``: a dense cache's layers; ``migrate_paged_pool``: a
whole block pool, in place). Where the reference device_puts under a
``NamedSharding``, the port's placement is a per-dimension tuple, its own
``PartitionSpec``: each entry None (not split), an axis name (``"r0"``)
or a tuple of them, r0 the most significant. The owner's values (rank
0's) reach every rank by a broadcast, in place; a replicated
placement (no split entry, ``()``) keeps them whole, in the same
storage, and a split one keeps a copy of this rank's shard alone, so
the full tensor is freed once the caller drops the old tree. The
broadcast is the only point-to-many collective both gloo and NCCL take
for CUDA tensors, so every rank receives every byte of a split leaf
too: ``bytes_moved`` is the reference's ``tree_bytes`` of the matched
leaves either way.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Optional

import numpy as np
import torch

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


def _shard_of(t: torch.Tensor, spec, group) -> torch.Tensor:
    """This rank's shard of ``t`` under the placement ``spec``: ``t``
    itself where nothing is split, else a copy of the shard in storage
    of its own (a view would keep the whole tensor alive)."""
    if len(spec) > t.dim():
        raise ValueError(f"placement {spec} has more entries than the "
                         f"{t.dim()} dims of a {tuple(t.shape)} tensor")
    full = t
    for dim, axes in enumerate(spec):
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        n, idx = 1, 0
        for a in axes:
            size = group.axis_size(a)
            n, idx = n * size, idx * size + group.axis_index(a)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"{n} ways")
        step = t.shape[dim] // n
        t = t.narrow(dim, idx * step, step)
    return t if t.shape == full.shape else t.clone()


def migrate_by_path(tree, path_regex: str, new_spec, group, *,
                    link_bandwidth: float = 50e9, measure: bool = False):
    """Re-place every leaf whose '/'-joined path matches ``path_regex``
    under ``new_spec`` (module docstring): each such tensor takes rank
    0's values in place (a broadcast over ``group``), and the new
    tree holds it whole or a copy of this rank's shard of it; other
    leaves are kept. ``bytes_moved`` counts the matched leaves (``tree_bytes``).
    Returns (new_tree, MigrationCost)."""
    pat = re.compile(path_regex)
    moved = 0

    def place(path, leaf):
        nonlocal moved
        if not pat.search(_PATH_JOIN.join(path)):
            return leaf
        moved += leaf.numel() * leaf.element_size()
        return _shard_of(group.broadcast(leaf), new_spec, group)

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
