"""The paper's speedup model (§4.1, Eqs. 1-4) — modified Amdahl's law.

* Eq. 1  W(P)  — accumulated per-layer compute, max over replicas.
* Eq. 2  T(P)  — replication communication, charged per replica entry and
  weighted by δ, the count of non-consecutive layer transitions.
* Eq. 3  S(P)  = W(P0) / (W(P) + T(P)).
* Eq. 4  S_homo(P) = 1 / (γ + (1-γ)/n · Σ_i 1/p_i), γ = δ·C/(d·B).

W and T are *proxies* positively correlated with real times (the paper says
so explicitly); only ratios are meaningful.

Copy of ``repro.core.speedup`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.cluster import Cluster
from repro_torch.core.plan import PlacementPlan


@dataclasses.dataclass(frozen=True)
class SpeedupModelConfig:
    d_model: int
    seq_len: int
    batch_size: int
    delta: float = 1.0            # per-boundary communication weight (δ)
    elem_bytes: int = 2           # bf16 activations on the wire
    flops_per_token_scale: float = 2.0  # 2 FLOPs per MAC


def even_batch_split(bs: int, p: int) -> List[int]:
    """The paper's even split (7/8 for bs=15, p=2 in Fig. 4)."""
    base, rem = divmod(bs, p)
    return [base + (1 if j < rem else 0) for j in range(p)]


def w_of(plan: PlacementPlan, m: SpeedupModelConfig,
         cluster: Cluster) -> float:
    """Eq. 1: W(P) = Σ_i max_j d² · bs_ij · l / C_ij."""
    total = 0.0
    for i in range(plan.n_layers):
        devs = plan.device_set(i)
        shares = even_batch_split(m.batch_size, len(devs))
        total += max(
            m.flops_per_token_scale * (m.d_model ** 2) * bs_ij * m.seq_len /
            cluster.device(dev).compute_flops
            for bs_ij, dev in zip(shares, devs))
    return total


def t_of(plan: PlacementPlan, m: SpeedupModelConfig,
         cluster: Cluster) -> float:
    """Eq. 2: T(P) = δ · Σ_i Σ_{j=1}^{p_i-1} d · bs_ij · l / B_ij.

    δ is realised as the plan's actual continuity-break count divided by the
    number of replicated layers (a uniform per-boundary weight): contiguous
    replica runs communicate only at their end points (§3.1).
    """
    breaks = plan.continuity_breaks()
    if breaks == 0:
        return 0.0
    rep_layers = max(plan.replicated_layer_count(), 1)
    delta_eff = m.delta * breaks / rep_layers
    total = 0.0
    for i in range(plan.n_layers):
        devs = plan.device_set(i)
        if len(devs) == 1:
            continue
        shares = even_batch_split(m.batch_size, len(devs))
        for bs_ij in shares[1:]:
            total += (m.elem_bytes * m.d_model * bs_ij * m.seq_len
                      / cluster.link_bandwidth)
    return delta_eff * total


def speedup(plan: PlacementPlan, m: SpeedupModelConfig,
            cluster: Cluster) -> float:
    """Eq. 3 for arbitrary (heterogeneous) clusters."""
    base = PlacementPlan.initial(plan.n_layers, plan.home_device)
    w0 = w_of(base, m, cluster)
    return w0 / (w_of(plan, m, cluster) + t_of(plan, m, cluster))


def gamma_of(cluster: Cluster, m: SpeedupModelConfig,
             breaks_per_layer: float = 0.05) -> float:
    """γ = δ·C/(d·B) — the homogeneous-cluster configuration constant.

    ``breaks_per_layer`` amortizes the boundary count over the stack (the
    paper's continuity-sorted plans keep replicas contiguous, so a handful of
    scatter/gather boundaries is spread over n layers).  C in FLOP/s, B in
    elements/s; the per-MAC factor cancels between W and T only partially,
    hence the explicit flops/elem scales.
    """
    c = cluster.devices[0].compute_flops / m.flops_per_token_scale
    b = cluster.link_bandwidth / m.elem_bytes
    return m.delta * breaks_per_layer * c / (m.d_model * b)


def speedup_homo(p: Sequence[int], gamma: float) -> float:
    """Eq. 4: S_homo(P) = 1 / (γ·[any replication] + (1-γ)/n · Σ 1/p_i).

    With P = P0 (all ones) the sum is n, so S = 1/(γ+(1-γ)) = 1 exactly when
    γ is charged; the paper's convention charges γ only once replication
    exists — we follow the formula literally (Σ 1/p_i handles P0: the γ term
    is constant, so S(P0)=1 requires γ + (1-γ) = 1, which holds).
    """
    n = len(p)
    inv = sum(1.0 / pi for pi in p)
    return 1.0 / (gamma + (1.0 - gamma) / n * inv)
