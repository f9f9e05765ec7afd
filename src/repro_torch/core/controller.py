"""Auto-Scaling Controller (§5): the closed control loop.

Every tick it reads the Monitor and
* triggers **scale-up** (Alg. 1) when the resource vacancy rate exceeds T_up,
* triggers **scale-down** (Alg. 2) when the SLO violation rate exceeds
  T_down (or an OOM / pool-pressure preemption was observed),
then pushes the updated plan to the Scheduler via ``on_plan_change``.

Live-telemetry interface: ``observe()`` feeds a snapshot straight into the
monitor, and after a scale-down tick ``last_scale_down`` holds the full
:class:`ScaleDownResult` — including structured ``migrations`` tuples — so
a live executor (serving/orchestrator.py) can turn kv_cache migrations
into actual block transfers between engines instead of parsing log lines.

Copy of ``repro.core.controller`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.core.cluster import Cluster
from repro_torch.core.monitor import MetricsSnapshot, Monitor
from repro_torch.core.plan import PlacementPlan
from repro_torch.core import scale_up as SU
from repro_torch.core import scale_down as SD


@dataclasses.dataclass
class ControllerConfig:
    t_up: float = 0.35            # vacancy rate above which we scale up
    t_down: float = 0.05          # SLO violation rate above which we scale down
    gamma: float = 0.02           # Eq. 4 cluster constant
    replica_size: float = 605e6   # r — one decoder layer (Table 1)
    delta_bs: int = 5
    cooldown_ticks: int = 2
    dop: int = 2                  # max replication degree (paper default)
    min_vacancy: float = 0.1      # eligibility floor for replica hosts
    # component -> bytes for scale-down destination fitting; None keeps
    # scale_down's Table-1 defaults. The live orchestrator sets these
    # from REAL footprints (its pool bytes / measured replica size).
    module_bytes: Optional[dict] = None


@dataclasses.dataclass
class PodElasticityConfig:
    """Pod-LEVEL elasticity knobs (DESIGN.md §11): beyond rebalancing a
    fixed instance set (module scaling, Table 2), the controller may
    GROW the pod (spawn a whole engine-server worker) under sustained
    pressure and SHRINK it (drain a worker through the zero-drop
    migration path, then reap) when the pod runs mostly empty —
    ScaleLLM-style whole-replica scaling driven by the same monitor
    signals Alg. 1/2 read.

    Both directions are deliberately sluggish: ``patience`` consecutive
    pressure/idle ticks before acting, a shared ``cooldown_ticks``
    between pod actions, and ``flap_guard_s`` under which a just-grown
    worker is never a shrink target (a grow immediately followed by a
    shrink must not orphan a booting worker). Shrink is additionally
    gated by the Table-2-style cost model: the estimated drain cost
    (bytes to migrate / link bandwidth) must stay under
    ``max_drain_s``."""
    min_instances: int = 1
    max_instances: int = 8
    # grow when pod-wide block vacancy falls BELOW this (pools filling)…
    t_grow_vacancy: float = 0.15
    # …or the backlog per instance exceeds this many queued requests
    t_grow_queue: float = 4.0
    # shrink when vacancy stays ABOVE this with an empty queue
    t_shrink_vacancy: float = 0.85
    patience: int = 2
    cooldown_ticks: int = 4
    flap_guard_s: float = 1.0
    max_drain_s: float = 5.0


class Controller:
    def __init__(self, cfg: ControllerConfig, cluster: Cluster,
                 plan: PlacementPlan, monitor: Monitor, *,
                 batch_size: int = 16,
                 is_violating: Optional[Callable] = None,
                 on_plan_change: Optional[Callable] = None,
                 commit_replica: Optional[Callable] = None,
                 pod_cfg: Optional[PodElasticityConfig] = None):
        self.cfg = cfg
        self.cluster = cluster
        self.plan = plan
        self.monitor = monitor
        self.batch_size = batch_size
        self.is_violating = is_violating or (lambda plan, bs: False)
        self.on_plan_change = on_plan_change or (lambda plan, bs: None)
        self.commit_replica = commit_replica
        self._cooldown = 0
        self.log: List[str] = []
        self.last_scale_down: Optional[SD.ScaleDownResult] = None
        # pod elasticity state (pod_tick): persistence votes + cooldown
        self.pod_cfg = pod_cfg
        self._grow_votes = 0
        self._shrink_votes = 0
        self._pod_cooldown = 0

    def observe(self, snap: MetricsSnapshot):
        """Live-telemetry entry point: record one snapshot (built by the
        orchestrator from real engine instrumentation) into the monitor."""
        self.monitor.record(snap)

    def tick(self, in_burst: bool = False) -> Optional[str]:
        """One control period. Returns the action taken (or None).

        ``in_burst=True`` marks a FEEDBACK iteration inside the same
        control burst (the live executor applied a remediation, fed the
        post-action snapshot back via ``observe``, and is asking whether
        Alg. 2 wants another phase): the cooldown gate is bypassed and
        not re-armed — the burst's FIRST action already armed it, and a
        burst is one remediation episode, not several."""
        if self._cooldown > 0 and not in_burst:
            self._cooldown -= 1
            return None
        snap = self.monitor.latest
        if snap is None:
            return None
        action = None
        violation = (self.monitor.slo_violation_rate() > self.cfg.t_down
                     or snap.oom_events > 0
                     or self.monitor.pool_pressure())
        if violation:
            hot = self.monitor.hottest_device() or self.plan.home_device
            res = SD.scale_down(
                self.plan, self.cluster, src_device=hot,
                is_violating=self.is_violating,
                batch_size=self.batch_size, delta_bs=self.cfg.delta_bs,
                module_bytes=self.cfg.module_bytes,
                mem_bound=self.monitor.is_memory_bound(hot))
            self.plan = res.plan
            self.batch_size = res.batch_size
            self.last_scale_down = res
            action = f"scale-down[{'+'.join(res.actions) or 'noop'}]"
        elif (self.monitor.vacancy_rate() > self.cfg.t_up
              and self.monitor.block_vacancy_rate() > self.cfg.min_vacancy):
            # live engines gate scale-up on POOL vacancy too: a layer
            # replica is pointless on instances whose KV pools are full
            # (simulator snapshots carry no block telemetry -> rate 1.0)
            before = list(self.plan.p)
            self.plan = SU.scale_up(
                self.plan, self.cluster, gamma=self.cfg.gamma,
                replica_size=self.cfg.replica_size,
                max_degree=self.cfg.dop,
                min_vacancy=self.cfg.min_vacancy,
                commit=self.commit_replica)
            if self.plan.p != before:
                action = (f"scale-up[replicated {sum(self.plan.p) - sum(before)}"
                          f" layer replicas]")
        if action:
            self.log.append(action)
            self.on_plan_change(self.plan, self.batch_size)
            if not in_burst:
                self._cooldown = self.cfg.cooldown_ticks
        return action

    # ------------------------------------------------------ pod elasticity
    def pod_tick(self, pod_size: int,
                 est_drain_s: float = 0.0) -> Optional[str]:
        """Pod-LEVEL decision (PodElasticityConfig docstring): returns
        ``"grow"``, ``"shrink"``, or None. The live executor
        (serving/orchestrator.py) calls this once per control tick with
        the current pod population and, for the shrink gate, the
        estimated drain cost of its cheapest shrink target — the same
        bytes/bandwidth cost model (core/migration.estimate_cost) the
        Table-2 module operations are priced by. Pressure votes
        (vacancy collapse, backlog, SLO violations) must persist for
        ``patience`` consecutive ticks before either action fires, and
        any firing re-arms the pod cooldown."""
        pcfg = self.pod_cfg
        snap = self.monitor.latest
        if pcfg is None or snap is None:
            return None
        if self._pod_cooldown > 0:
            self._pod_cooldown -= 1
            return None
        vac = self.monitor.block_vacancy_rate()
        backlog = snap.queue_len / max(pod_size, 1)
        pressure = (vac < pcfg.t_grow_vacancy
                    or backlog > pcfg.t_grow_queue
                    or self.monitor.slo_violation_rate() > self.cfg.t_down)
        idle = vac > pcfg.t_shrink_vacancy and snap.queue_len == 0
        if pressure and pod_size < pcfg.max_instances:
            self._shrink_votes = 0
            self._grow_votes += 1
            if self._grow_votes >= pcfg.patience:
                self._grow_votes = 0
                self._pod_cooldown = pcfg.cooldown_ticks
                self.log.append(f"grow-pod[vacancy={vac:.2f} "
                                f"backlog={backlog:.1f}]")
                return "grow"
        elif idle and pod_size > pcfg.min_instances:
            self._grow_votes = 0
            self._shrink_votes += 1
            if self._shrink_votes >= pcfg.patience:
                self._shrink_votes = 0
                if est_drain_s > pcfg.max_drain_s:
                    # Table-2 cost gate: reaping this worker would stall
                    # its streams longer than the idleness is worth
                    self.log.append(
                        f"shrink-pod-skipped[est_drain={est_drain_s:.2f}s"
                        f" > {pcfg.max_drain_s:.2f}s]")
                    return None
                self._pod_cooldown = pcfg.cooldown_ticks
                self.log.append(f"shrink-pod[vacancy={vac:.2f} "
                                f"est_drain={est_drain_s:.2f}s]")
                return "shrink"
        else:
            self._grow_votes = 0
            self._shrink_votes = 0
        return None
