"""Scale-Up (Algorithm 1): greedy layer replication maximizing modeled
speedup, candidates sorted by layer continuity to minimize scatter/gather
boundaries.

Faithful to the paper: computes the current speedup via Eq. 4 (``1/(γ +
(1-γ)/n · ‖1 ⊘ P‖₁)``), iterates eligible nodes (by vacancy), derives
``max_replicas`` from free capacity / replica size r, sorts candidates by
continuity, simulates each replica addition and commits it only on speedup
improvement — guaranteeing monotone improvement.

Copy of ``repro.core.scale_up`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.core.cluster import Cluster
from repro_torch.core.plan import PlacementPlan
from repro_torch.core.speedup import speedup_homo


def _inv_norm(p: List[int]) -> float:
    """‖1 ⊘ P‖₁ — L1 norm of the Hadamard quotient (paper's notation)."""
    return sum(1.0 / pi for pi in p)


def sort_candidates_by_continuity(plan: PlacementPlan, device_id: int,
                                  max_replicas: int) -> List[int]:
    """Priority: extend the longest contiguous replica run on this device;
    ties (and the no-replica-yet case) fall back to ascending layer id.

    Returns up to ``max_replicas`` candidate layer ids not yet replicated on
    the device.
    """
    on_dev = {i for i in range(plan.n_layers)
              if device_id in plan.replicas.get(i, [])}
    candidates = [i for i in range(plan.n_layers) if i not in on_dev]

    # longest contiguous run of already-replicated layers on this device
    runs = []  # (start, end) inclusive
    start = None
    for i in range(plan.n_layers + 1):
        if i < plan.n_layers and i in on_dev:
            if start is None:
                start = i
        else:
            if start is not None:
                runs.append((start, i - 1))
                start = None
    runs.sort(key=lambda r: -(r[1] - r[0] + 1))

    def priority(layer: int):
        # adjacency to the longest runs first, then layer index
        for rank, (s, e) in enumerate(runs):
            if layer == s - 1 or layer == e + 1:
                return (0, rank, layer)
        return (1, 0, layer)

    candidates.sort(key=priority)
    return candidates[:max_replicas]


def scale_up(plan: PlacementPlan, cluster: Cluster, *, gamma: float,
             replica_size: float,
             min_vacancy: float = 0.2,
             include_home: bool = False,
             max_degree: int = 2,
             commit: Optional[Callable[[int, int], None]] = None
             ) -> PlacementPlan:
    """Algorithm 1. ``replica_size`` is r (bytes+compute footprint of one
    layer replica); ``commit(layer, device)`` is the side-effecting
    ``replicate(model, layer_id, g_dst)`` hook (e.g. core/replication.py or
    the simulator's deployment table).
    Returns the improved plan P*.
    """
    best = plan.copy()
    sp_best = speedup_homo(best.p, gamma)
    for dev in cluster.eligible_nodes(min_vacancy):
        if dev.device_id == plan.home_device and not include_home:
            continue  # a replica co-located with its source adds no speedup
        max_replicas = int(dev.free_mem // replica_size)
        if max_replicas <= 0:
            continue
        candidates = sort_candidates_by_continuity(best, dev.device_id,
                                                   max_replicas)
        for layer_id in candidates:
            if best.p[layer_id] >= max_degree:  # paper's dop cap (Fig. 6c/d)
                continue
            trial = best.copy()
            trial.add_replica(layer_id, dev.device_id)
            sp = speedup_homo(trial.p, gamma)
            if sp > sp_best:
                best = trial
                sp_best = sp
                dev.used_mem += replica_size
                if commit is not None:
                    commit(layer_id, dev.device_id)
    return best


def scale_up_hetero(plan: PlacementPlan, cluster: Cluster, *,
                    model: "object", replica_size: float,
                    min_vacancy: float = 0.2, max_degree: int = 4,
                    commit: Optional[Callable[[int, int], None]] = None
                    ) -> PlacementPlan:
    """Heterogeneous-cluster variant of Algorithm 1 (paper §8): scores
    candidate replicas with the EXACT Eq. 3 speedup (per-device compute
    capacities and link bandwidths) instead of the homogeneous Eq. 4 closed
    form. ``model`` is a SpeedupModelConfig.
    """
    from repro_torch.core.speedup import speedup

    best = plan.copy()
    sp_best = speedup(best, model, cluster)
    for dev in cluster.eligible_nodes(min_vacancy):
        if dev.device_id == plan.home_device:
            continue
        max_replicas = int(dev.free_mem // replica_size)
        if max_replicas <= 0:
            continue
        for layer_id in sort_candidates_by_continuity(best, dev.device_id,
                                                      max_replicas):
            if best.p[layer_id] >= max_degree:
                continue
            trial = best.copy()
            trial.add_replica(layer_id, dev.device_id)
            sp = speedup(trial, model, cluster)
            if sp > sp_best:
                best = trial
                sp_best = sp
                dev.used_mem += replica_size
                if commit is not None:
                    commit(layer_id, dev.device_id)
    return best
