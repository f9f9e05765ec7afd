"""Scale-Down / Module Reduction (Algorithm 2): three graduated phases.

(a) Module Migration    — move memory/compute-heavy modules off the hot
                          device (candidates filtered per §3.3 analysis);
(b) Replica Eviction    — drop co-located layer replicas, least-impact first;
(c) Performance Reduction — shrink batch size by Δbs and offload.

Each phase re-checks the violation predicate and stops as soon as the SLO is
restored — lower-impact remediations are exhausted before costly ones.

Copy of ``repro.core.scale_down`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.core.cluster import Cluster, Device
from repro_torch.core.plan import PlacementPlan

# migration preference order per the paper's §3.3 recommendations
_MIGRATION_ORDER = ("kv_cache", "ffn", "attn", "layer")


@dataclasses.dataclass
class ScaleDownResult:
    plan: PlacementPlan
    batch_size: int
    actions: List[str]
    resolved: bool
    # structured mirror of the Phase-1 entries in ``actions`` so live
    # executors (serving/orchestrator.py) don't parse strings:
    # (layer, component, src_device, dst_device)
    migrations: List[Tuple[int, str, int, int]] = dataclasses.field(
        default_factory=list)


def filter_modules(plan: PlacementPlan, cfg_profile: dict, device_id: int,
                   *, mem_bound: bool, max_candidates: int = 8
                   ) -> List[Tuple[int, str]]:
    """FilterModules(): candidate (layer, component) migrations off a device.

    Memory pressure prefers kv_cache / whole layers; compute pressure prefers
    attention and FFN projections (§3.3).
    """
    layers = plan.layers_on_device(device_id)
    order = (("kv_cache", "layer", "ffn", "attn") if mem_bound
             else ("attn", "ffn", "layer", "kv_cache"))
    out: List[Tuple[int, str]] = []
    for comp in order:
        for layer in layers:
            if (layer, comp) in plan.migrated:
                continue
            out.append((layer, comp))
            if len(out) >= max_candidates:
                return out
    return out


def find_optimal_destination(cluster: Cluster, need_bytes: float,
                             exclude: int) -> Optional[Device]:
    cands = [d for d in cluster.devices
             if d.device_id != exclude and d.free_mem >= need_bytes]
    if not cands:
        return None
    return max(cands, key=lambda d: d.vacancy_rate)


def sort_evictees(plan: PlacementPlan, device_id: int) -> List[int]:
    """Replicas on the hot device, least-performance-impact first: layers
    whose eviction removes the fewest continuity breaks (isolated replicas
    go first, long contiguous runs are kept)."""
    reps = [i for i in range(plan.n_layers)
            if device_id in plan.replicas.get(i, [])]

    def impact(layer: int) -> Tuple[int, int]:
        trial = plan.copy()
        trial.evict_replica(layer, device_id)
        # prefer evictions that REDUCE boundaries the most (isolated
        # replicas first); never prefer splitting a contiguous run
        reduction = plan.continuity_breaks() - trial.continuity_breaks()
        return (-reduction, layer)

    return sorted(reps, key=impact)


def scale_down(plan: PlacementPlan, cluster: Cluster, *, src_device: int,
               is_violating: Callable[[PlacementPlan, int], bool],
               batch_size: int, delta_bs: int = 5,
               module_bytes: Optional[dict] = None,
               mem_bound: bool = True,
               offload: Optional[Callable[[], None]] = None
               ) -> ScaleDownResult:
    """Algorithm 2. ``is_violating(plan, batch_size)`` is the SLO/OOM
    predicate (fed by the Monitor in the live system, by the cluster state in
    the simulator). ``module_bytes`` maps component -> bytes for destination
    fitting (defaults to Table-1-ish fractions of a layer)."""
    actions: List[str] = []
    migrations: List[Tuple[int, str, int, int]] = []
    cur = plan.copy()
    module_bytes = module_bytes or {
        "layer": 605e6, "attn": 200e6, "ffn": 405e6, "kv_cache": 1e9}

    # -------------------------------------------------- Phase 1: migration
    for layer, comp in filter_modules(cur, module_bytes, src_device,
                                      mem_bound=mem_bound):
        dst = find_optimal_destination(cluster, module_bytes.get(comp, 0.0),
                                       src_device)
        if dst is None:
            continue
        cur.migrate(layer, comp, dst.device_id)
        dst.used_mem += module_bytes.get(comp, 0.0)
        src = cluster.device(src_device)
        src.used_mem = max(0.0, src.used_mem - module_bytes.get(comp, 0.0))
        actions.append(f"migrate L{layer}.{comp} {src_device}->{dst.device_id}")
        migrations.append((layer, comp, src_device, dst.device_id))
        if not is_violating(cur, batch_size):
            return ScaleDownResult(cur, batch_size, actions, True, migrations)

    # --------------------------------------------- Phase 2: replica eviction
    for layer in sort_evictees(cur, src_device):
        cur.evict_replica(layer, src_device)
        actions.append(f"evict replica L{layer} on dev{src_device}")
        if not is_violating(cur, batch_size):
            return ScaleDownResult(cur, batch_size, actions, True, migrations)

    # ----------------------------------------- Phase 3: performance reduction
    bs = batch_size
    while is_violating(cur, bs) and bs >= 1:
        bs = max(1, bs - delta_bs)
        actions.append(f"reduce batch -> {bs}")
        if offload is not None:
            offload()
            actions.append("offload params/kv")
        if not is_violating(cur, bs):
            break
        if bs == 1:
            break
    return ScaleDownResult(cur, bs, actions, not is_violating(cur, bs),
                           migrations)
