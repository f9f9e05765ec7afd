"""Module migration — re-placement of parameters / caches (§3.1, §3.3).

Counterpart of ``repro.core.migration``. The cost model (bytes moved /
link bandwidth + a fixed per-migration overhead) has the shape of the
paper's Table 2; ``fit_migration_model`` fits its two constants to the
host it runs on. What this port moves is the unit CoCoServe's live
scale-down moves: ``migrate_blocks`` ships one request's KV blocks
between two engines' block pools (the wire format of
``serving/paged_kv.export_blocks``).

Re-sharding a tree, a dense cache or a whole pool under a new placement
across cards (``migrate_by_path``, ``migrate_kv_cache``,
``migrate_paged_pool``) waits for multi-card replication (ROADMAP A10).
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


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} re-shards under a placement across cards, which is not "
        f"ported yet (ROADMAP A10)")


def migrate_by_path(tree, path_regex: str, new_spec, mesh, **kw):
    _not_ported("migrate_by_path")


def migrate_kv_cache(cache, new_spec, mesh, **kw):
    _not_ported("migrate_kv_cache")


def migrate_paged_pool(state, new_spec, mesh, **kw):
    _not_ported("migrate_paged_pool")


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
