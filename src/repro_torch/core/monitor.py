"""Metrics Monitor (§5): rolling-window metric collection feeding the
Controller. In the paper this reads NVML + engine timers; here it is fed
by the serving simulator and/or — through the live-telemetry interface —
the real paged Engine fleet (serving/orchestrator.py builds snapshots out
of serving/instrument.EngineTelemetry: block-pool vacancy, queue depth,
per-step wall latency, SLO violations).

Copy of ``repro.core.monitor`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional


@dataclasses.dataclass
class MetricsSnapshot:
    t: float
    rps: float = 0.0
    tokens_per_s: float = 0.0
    p50_latency: float = 0.0
    p95_latency: float = 0.0
    slo_violation_rate: float = 0.0
    oom_events: int = 0
    queue_len: int = 0
    device_util: Optional[List[float]] = None       # 0..1 compute per device
    device_mem_frac: Optional[List[float]] = None   # 0..1 memory per device
    # --- live paged-engine telemetry (None when fed by the simulator) ---
    block_vacancy: Optional[List[float]] = None     # 0..1 free pool fraction
    step_seconds: float = 0.0                       # mean wall s per step
    preemptions: int = 0                            # pool-pressure evictions
    # --- prefix sharing (the vacancy signal already reflects sharing:
    # aliased blocks never leave the free count; these gauges say how much
    # of that vacancy copy-on-write sharing is buying) ---
    prefix_hit_rate: float = 0.0    # hit fraction of prompt-block lookups
    blocks_saved: int = 0           # physical blocks saved NOW by sharing
    # --- continuous batching (token-budget scheduler, DESIGN.md §10):
    # how full the per-step token budget packs, and how long requests
    # wait for their first token — the signals SLO-aware admission and
    # the controller's scale decisions act on ---
    budget_utilization: float = 0.0  # mean packed/budget over the window
    ttft_p50: float = 0.0            # engine-clock time-to-first-token
    ttft_p95: float = 0.0
    queue_delay_p95: float = 0.0     # submit -> first prefill chunk
    # --- failure domain (DESIGN.md §9): cumulative plane-wide counters,
    # all 0 outside chaos runs / real incidents ---
    faults_injected: int = 0        # transport faults the harness injected
    rpc_timeouts: int = 0           # calls that missed their deadline
    quarantines: int = 0            # hung peers severed + killed
    respawns: int = 0               # supervised restarts re-admitted
    # --- pod elasticity (DESIGN.md §11): how many serving instances the
    # pod currently has (alive, non-retired) — the population the
    # controller's grow/shrink decisions act on ---
    pod_size: int = 0


class Monitor:
    def __init__(self, window: int = 16):
        self.history: Deque[MetricsSnapshot] = deque(maxlen=window)

    def record(self, snap: MetricsSnapshot):
        self.history.append(snap)

    @property
    def latest(self) -> Optional[MetricsSnapshot]:
        return self.history[-1] if self.history else None

    def mean(self, field: str) -> float:
        vals = [getattr(s, field) for s in self.history
                if getattr(s, field) is not None]
        return sum(vals) / len(vals) if vals else 0.0

    def vacancy_rate(self) -> float:
        """Cluster-wide COMPUTE vacancy (drives T_up in §5).

        Deliberately compute-only: the paper's motivating waste is idle
        computational fragments on memory-full devices (a 70B instance
        spanning 4 GPUs leaves compute idle at low RPS) — replication can
        still exploit them as long as a layer replica fits (per-device
        free_mem gates that separately in Alg. 1).
        """
        snap = self.latest
        if snap is None or not snap.device_util:
            return 1.0
        # None entries are RETIRED pod slots (index kept for alignment,
        # instance reaped): they are not capacity, so they are excluded
        # from the average rather than counted busy or idle
        per_dev = [1.0 - u for u in snap.device_util if u is not None]
        return sum(per_dev) / len(per_dev) if per_dev else 1.0

    def slo_violation_rate(self) -> float:
        return self.mean("slo_violation_rate")

    def block_vacancy_rate(self) -> float:
        """Mean free fraction of the engines' block pools — the MEMORY
        vacancy signal of the live loop (what replication's KV blocks and
        scale-down migrations compete for)."""
        snap = self.latest
        if snap is None or not snap.block_vacancy:
            return 1.0
        vals = [v for v in snap.block_vacancy if v is not None]
        return sum(vals) / len(vals) if vals else 1.0

    def prefix_hit_rate(self) -> float:
        """Latest prompt-prefix cache hit rate across the fleet — how
        much of the admission load the block pool absorbs by aliasing
        instead of re-prefilling (0 when sharing is off or unexercised)."""
        snap = self.latest
        return snap.prefix_hit_rate if snap is not None else 0.0

    def blocks_saved_by_sharing(self) -> int:
        """Physical pool blocks currently saved by copy-on-write sharing
        (summed over instances) — the headroom sharing adds to the
        vacancy signal the §5 controller scales on."""
        snap = self.latest
        return snap.blocks_saved if snap is not None else 0

    def pool_pressure(self) -> bool:
        """OOM-analogue of the live loop: a preemption (a request evicted
        back to the queue for pool room) is the paged engine's recoverable
        out-of-memory event."""
        snap = self.latest
        return snap is not None and snap.preemptions > 0

    def hottest_device(self) -> Optional[int]:
        snap = self.latest
        if snap is None or not snap.device_util:
            return None
        load = [(-1.0 if u is None            # retired slot: never hot
                 else max(u, m if m is not None else 0.0))
                for u, m in zip(snap.device_util, snap.device_mem_frac
                                or [0.0] * len(snap.device_util))]
        if max(load) < 0:
            return None
        return max(range(len(load)), key=load.__getitem__)

    def is_memory_bound(self, device_id: int) -> bool:
        snap = self.latest
        if snap is None or not snap.device_mem_frac:
            return True
        mem = snap.device_mem_frac[device_id]
        util = (snap.device_util
                or [0.0] * len(snap.device_mem_frac))[device_id]
        if mem is None or util is None:
            return True
        return mem >= util
