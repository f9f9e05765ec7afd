"""Event-driven cluster serving simulator.

Reproduces the paper's evaluation (Figs. 2/3/6/8/10/11) on this CPU-only
container: per-iteration latency comes from an analytic roofline cost model
(compute / HBM / interconnect — the same constants as EXPERIMENTS.md), memory
from the Table-1 module footprints, and the three serving systems differ
exactly along the axes the paper describes:

* ``hft``       — static batching (a batch runs to completion before new
  admissions), KV reserved at max length (fragmentation), no admission
  control: memory overrun = OOM failure, batch dropped + restart stall.
* ``vllm``      — continuous batching + paged KV (allocate-as-you-go, small
  page overhead), admission control prevents most OOM.
* ``cocoserve`` — ``vllm`` scheduling + the CoCoServe Controller: layer
  replication (Alg. 1) accelerates iterations per the speedup model, and
  Module Reduction (Alg. 2) migrates KV/layers before violations escalate.

The simulator is intentionally deterministic given (workload seed, config).

Copy of ``repro.serving.simulator`` for the port, over the port's copies
of ``core/{cluster,controller,monitor,plan,speedup}``. Its constants
describe the paper's A100 testbed, as the reference's do: the
reference's simulator has no preset of its dry-run target either (the
port's target, ``Cluster.h100``, is the dry run's).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import Cluster, layer_weight_bytes
from repro_torch.core.controller import Controller, ControllerConfig
from repro_torch.core.monitor import Monitor, MetricsSnapshot
from repro_torch.core.plan import PlacementPlan
from repro_torch.core.speedup import (SpeedupModelConfig, gamma_of, speedup_homo)
from repro_torch.serving.kvcache import kv_bytes_per_token
from repro_torch.serving.workload import SimRequest, WorkloadConfig, generate


# Kernel efficiency (fraction of peak the serving stack reaches). The paper's
# Fig. 2 shows HFT leaving 20-40% of the GPU idle and suffering Python-level
# serial overheads; vLLM/CoCoServe run fused paged-attention kernels.
SYSTEM_EFFICIENCY = {"hft": 0.08, "vllm": 0.50, "cocoserve": 0.50}
# Effective HBM efficiency (naive attention re-reads & fragmentation vs paged)
SYSTEM_MEM_EFF = {"hft": 0.75, "vllm": 0.85, "cocoserve": 0.85}
# Static batch cap: HFT uses the paper's default static batch of 15;
# continuous batching admits until memory admission control stops it.
SYSTEM_BATCH_CAP = {"hft": 20, "vllm": 48, "cocoserve": 48}
# Pipelined overlap efficiency once layers span multiple devices (the paper's
# degree-of-parallelism effect, Fig. 6c/d): each extra device contributes a
# modest fraction of its HBM bandwidth to the aggregate weight stream.
PIPELINE_OVERLAP = 0.15
# HFT OOM model: a naive allocator under queue pressure (no paging, dynamic
# per-request tensors + fragmentation) fails once the backlog exceeds this
# multiple of the batch capacity (Fig. 11a).
HFT_OOM_QUEUE_FACTOR = 6.0


@dataclasses.dataclass
class SimConfig:
    model: ModelConfig
    system: str = "cocoserve"          # hft | vllm | cocoserve
    n_devices: int = 4
    n_instances: int = 1
    max_batch: int = 0                 # 0 -> SYSTEM_BATCH_CAP default
    max_seq: int = 768                 # prompt + 256 gen + slack
    slo_latency_s: float = 12.0
    hbm_bw: float = 1.5e12             # A100: ~1.5 TB/s
    restart_stall_s: float = 3.0      # HFT OOM recovery
    page_overhead: float = 0.04
    controller_period_s: float = 1.0
    tick_floor_s: float = 1e-3
    queue_timeout_s: float = 30.0      # client gives up waiting (all systems)
    # Fig. 6 sweep support: pre-replicate N layers at degree dop across the
    # other devices and (optionally) freeze the controller.
    preset_replicated_layers: int = 0
    preset_dop: int = 1
    enable_controller: bool = True
    # override the kernel-efficiency table (Fig. 6 reproduces the paper's
    # compute-bound HFT-based executor with replication added)
    efficiency_override: Optional[float] = None
    # set to paper's testbed by default
    device_mem_gb: float = 40.0
    device_flops: float = 312e12
    link_gbps: float = 64.0

    def __post_init__(self):
        if self.max_batch == 0:
            self.max_batch = SYSTEM_BATCH_CAP[self.system]


@dataclasses.dataclass
class SimResult:
    completed: List[SimRequest]
    dropped: int
    oom_events: int
    sim_time: float
    controller_log: List[str]
    peak_mem_per_device: List[float]

    # ------------------------------------------------------------- metrics
    def latencies(self):
        return np.array([r.latency for r in self.completed]) \
            if self.completed else np.array([float("inf")])

    @property
    def mean_latency(self) -> float:
        return float(np.mean(self.latencies()))

    @property
    def p95_latency(self) -> float:
        return float(np.percentile(self.latencies(), 95))

    @property
    def throughput_tokens(self) -> float:
        toks = sum(r.prompt_len + r.generated for r in self.completed)
        return toks / max(self.sim_time, 1e-9)

    @property
    def throughput_requests(self) -> float:
        return len(self.completed) / max(self.sim_time, 1e-9)

    def slo_attainment(self, slo: float) -> float:
        total = len(self.completed) + self.dropped
        if total == 0:
            return 1.0
        ok = sum(1 for r in self.completed if r.latency <= slo)
        return ok / total


class InstanceSim:
    """One model instance: cost model + memory accounting + batch state."""

    def __init__(self, sim: SimConfig, cluster: Cluster, home: int,
                 plan: Optional[PlacementPlan] = None):
        self.sim = sim
        cfg = sim.model
        self.cfg = cfg
        self.cluster = cluster
        self.home = home
        self.plan = plan or PlacementPlan.initial(cfg.num_layers, home)
        self.batch_cap = sim.max_batch
        self.running: List[SimRequest] = []
        self.stall_until = 0.0
        # static footprints
        self.weight_bytes = cfg.param_count() * 2
        self.layer_bytes = layer_weight_bytes(cfg)
        self.kv_per_token = kv_bytes_per_token(cfg)
        self.m = SpeedupModelConfig(d_model=cfg.d_model, seq_len=1,
                                    batch_size=max(sim.max_batch, 1))
        self.gamma = gamma_of(cluster, self.m)
        # big models span multiple devices (tensor parallel) like the
        # paper's 70B instance on 4xA100-40GB
        cap = cluster.device(home).mem_capacity
        self.span = min(sim.n_devices,
                        max(1, int(np.ceil(self.weight_bytes / (0.8 * cap)))))
        for j in range(self.span):
            dev = cluster.device((home + j) % sim.n_devices)
            dev.used_mem += self.weight_bytes / self.span

    # ------------------------------------------------------------- memory
    def kv_bytes_running(self) -> float:
        scale = 1.0 + self.sim.page_overhead
        if self.sim.system == "hft":
            # static allocation at max length for every admitted request
            return len(self.running) * self.sim.max_seq * self.kv_per_token
        toks = sum(r.prompt_len + r.generated for r in self.running)
        return toks * self.kv_per_token * scale

    def kv_home_fraction(self) -> float:
        """Fraction of this instance's KV still on the home device (the
        rest was migrated by Alg. 2 phase 1)."""
        migrated = sum(1 for (l, comp) in self.plan.migrated
                       if comp == "kv_cache")
        return 1.0 - migrated / max(self.cfg.num_layers, 1)

    def mem_on_home(self) -> float:
        return (self.weight_bytes / self.span
                + self.kv_bytes_running() * self.kv_home_fraction() / self.span)

    # ---------------------------------------------------------- cost model
    def _active_params(self) -> float:
        cfg = self.cfg
        n = self.weight_bytes / 2
        if cfg.num_experts:
            frac = ((cfg.num_experts_per_tok + cfg.num_shared_experts)
                    / max(cfg.num_experts, 1))
            n = n * min(1.0, frac + 0.3)
        return n

    def _iter_seconds(self, batch: int, mean_ctx: float, new_tokens: int
                      ) -> float:
        """One decode iteration: per-layer roofline, replication splits the
        batch p_i ways (compute AND this-batch KV reads), discontinuities pay
        scatter/gather on the link — the executable form of Eqs. 1-3."""
        cfg = self.cfg
        dev = self.cluster.device(self.home)
        eff = (self.sim.efficiency_override
               or SYSTEM_EFFICIENCY[self.sim.system])
        mem_eff = SYSTEM_MEM_EFF[self.sim.system]
        p = np.asarray(self.plan.p, dtype=np.float64)
        share = np.ceil(batch / p)                      # requests per replica
        n_layers = max(cfg.num_layers, 1)
        layer_params = self._active_params() / n_layers
        layer_bytes = 2.0 * layer_params
        # tensor-parallel span splits both compute and the weight stream
        span_eff = 1.0 + 0.9 * (self.span - 1)
        compute = (2.0 * layer_params * share
                   / (dev.compute_flops * eff * span_eff))
        kv_layer_ctx = mean_ctx * self.kv_per_token / n_layers
        # layers spread across k devices stream weights from k HBMs in a
        # pipelined fashion (the paper's dop effect, Fig. 6c/d)
        k_dev = max(len(self.plan.devices_used()), self.span)
        bw_factor = 1.0 + PIPELINE_OVERLAP * (k_dev - 1) \
            if self.span == 1 else span_eff
        mem = (layer_bytes / bw_factor + share * kv_layer_ctx) \
            / (self.sim.hbm_bw * mem_eff)
        layer_t = float(np.maximum(compute, mem).sum())
        # TP collectives for spanning instances (2 all-reduces per layer)
        if self.span > 1:
            layer_t += n_layers * (2 * 2 * cfg.d_model * batch
                                   / self.cluster.link_bandwidth + 4e-6)
        # lm head
        head = (2.0 * cfg.d_model * cfg.vocab_size * batch
                / (dev.compute_flops * eff * span_eff))
        # migrated KV is read over the interconnect every iteration
        mig_frac = 1.0 - self.kv_home_fraction()
        mig_t = (mig_frac * batch * mean_ctx * self.kv_per_token
                 / self.cluster.link_bandwidth)
        # scatter/gather at plan discontinuities (δ boundaries)
        breaks = self.plan.continuity_breaks()
        act_bytes = 2 * cfg.d_model * batch
        comm_t = breaks * (act_bytes / self.cluster.link_bandwidth + 4e-6)
        return layer_t + head + mig_t + comm_t

    def _prefill_seconds(self, tokens: int) -> float:
        dev = self.cluster.device(self.home)
        eff = (self.sim.efficiency_override
               or SYSTEM_EFFICIENCY[self.sim.system])
        sp = speedup_homo(self.plan.p, self.gamma)
        span_eff = 1.0 + 0.9 * (self.span - 1)
        return (2.0 * self._active_params() * tokens
                / (dev.compute_flops * eff * span_eff) / sp)


def _percentile(vals, q):
    return float(np.percentile(vals, q)) if len(vals) else 0.0


def simulate(sim: SimConfig, wl: WorkloadConfig) -> SimResult:
    cluster = Cluster.homogeneous(sim.n_devices, mem_gb=sim.device_mem_gb,
                                  flops=sim.device_flops,
                                  link_gbps=sim.link_gbps)
    instances = [InstanceSim(sim, cluster, home=i % sim.n_devices)
                 for i in range(sim.n_instances)]
    if sim.preset_replicated_layers:
        for inst in instances:
            others = [d for d in range(sim.n_devices) if d != inst.home]
            for i in range(min(sim.preset_replicated_layers,
                               sim.model.num_layers)):
                for j in range(sim.preset_dop - 1):
                    inst.plan.add_replica(i, others[j % len(others)])
    requests = generate(wl)
    pending = list(requests)
    completed: List[SimRequest] = []
    dropped = 0
    oom_events = 0
    ctrl_log: List[str] = []
    peak_mem = [0.0] * sim.n_devices

    monitors = [Monitor() for _ in instances]
    controllers: List[Optional[Controller]] = [None] * len(instances)
    if sim.system == "cocoserve" and sim.enable_controller:
        for i, inst in enumerate(instances):
            ccfg = ControllerConfig(replica_size=inst.layer_bytes,
                                    gamma=inst.gamma)

            def mk_violating(inst=inst):
                def f(plan, bs):
                    dev = cluster.device(inst.home)
                    old_plan, inst_plan = inst.plan, plan
                    inst.plan = plan
                    over_mem = inst.mem_on_home() > dev.mem_capacity * 0.92
                    it = inst._iter_seconds(max(len(inst.running), 1), 300, 1)
                    inst.plan = old_plan
                    # violating if memory critical or iteration too slow for SLO
                    return over_mem or (it * 256 > sim.slo_latency_s)
                return f

            controllers[i] = Controller(
                ccfg, cluster, inst.plan, monitors[i],
                batch_size=sim.max_batch, is_violating=mk_violating())

    t = 0.0
    next_ctrl = sim.controller_period_s
    recent_lat: List[float] = []
    guard = 0
    horizon = wl.duration_s + 600.0
    while (pending or any(inst.running for inst in instances)) and t < horizon:
        guard += 1
        if guard > 2_000_000:
            break
        # ---------------- client timeouts
        for r in [r for r in pending
                  if r.arrival <= t - sim.queue_timeout_s]:
            r.dropped = True
            pending.remove(r)
            dropped += 1

        # ---------------- admission
        for inst in instances:
            if t < inst.stall_until:
                continue
            free_now = [r for r in pending if r.arrival <= t]
            if sim.system == "hft":
                # static batching: only admit when the instance is idle
                if inst.running or not free_now:
                    continue
                # naive allocator under backlog pressure: fragmentation +
                # dynamic per-request tensors overflow -> OOM, batch lost
                if len(free_now) > HFT_OOM_QUEUE_FACTOR * inst.batch_cap:
                    oom_events += 1
                    inst.stall_until = t + sim.restart_stall_s
                    batch = free_now[:inst.batch_cap]
                    for r in batch:
                        r.dropped = True
                        pending.remove(r)
                        dropped += 1
                    continue
                batch = free_now[:inst.batch_cap]
                for r in batch:
                    pending.remove(r)
                inst.running = batch
                pf = inst._prefill_seconds(sum(r.prompt_len for r in batch))
                t_pf = t + pf
                for r in batch:
                    r.first_token = t_pf
            else:
                # continuous batching with admission control
                dev = cluster.device(inst.home)
                while (free_now and len(inst.running) < inst.batch_cap):
                    r = free_now[0]
                    new_kv = ((r.prompt_len + r.output_len)
                              * inst.kv_per_token * inst.kv_home_fraction()
                              / inst.span)
                    headroom = dev.mem_capacity * 0.96 - inst.mem_on_home()
                    if new_kv > headroom:
                        if sim.system == "vllm" and len(inst.running) == 0:
                            # cannot fit even alone -> genuine OOM drop
                            oom_events += 1
                            r.dropped = True
                            pending.remove(r)
                            free_now.pop(0)
                            dropped += 1
                            continue
                        break
                    pending.remove(r)
                    free_now.pop(0)
                    pf = inst._prefill_seconds(r.prompt_len)
                    r.first_token = t + pf
                    inst.running.append(r)
            # round-robin: one instance admits per pass, all get a chance

        # ---------------- one decode iteration per instance
        dt_candidates = []
        for inst in instances:
            if not inst.running or t < inst.stall_until:
                continue
            batch = len(inst.running)
            mean_ctx = np.mean([r.prompt_len + r.generated
                                for r in inst.running])
            it = inst._iter_seconds(batch, mean_ctx, batch)
            dt_candidates.append(it)
            for r in list(inst.running):
                if r.first_token > t:  # still prefilling
                    continue
                r.generated += 1
                if r.generated >= r.output_len:
                    r.finish = t + it
                    recent_lat.append(r.latency)
                    completed.append(r)
                    inst.running.remove(r)
        # advance time
        if dt_candidates:
            dt = max(min(dt_candidates), sim.tick_floor_s)
        elif pending:
            dt = max(min(r.arrival for r in pending) - t, sim.tick_floor_s)
        else:
            dt = sim.tick_floor_s
        t += dt

        # ---------------- memory accounting + monitor + controller
        for d in cluster.devices:
            base = sum(inst.mem_on_home() for inst in instances
                       if (d.device_id - inst.home) % sim.n_devices
                       < inst.span)
            repl = 0.0  # replica weights + migrated-in KV
            for inst in instances:
                for l, reps in inst.plan.replicas.items():
                    repl += reps.count(d.device_id) * inst.layer_bytes
                for (l, comp), dv in inst.plan.migrated.items():
                    if dv == d.device_id and comp == "kv_cache":
                        repl += (inst.kv_bytes_running()
                                 / max(inst.cfg.num_layers, 1))
            d.used_mem = base + repl
            peak_mem[d.device_id] = max(peak_mem[d.device_id], d.used_mem)
            d.util_compute = min(1.0, sum(
                len(inst.running) / inst.batch_cap for inst in instances
                if inst.home == d.device_id))

        if t >= next_ctrl:
            next_ctrl += sim.controller_period_s
            window = recent_lat[-64:]
            viol = (np.mean([1.0 if l > sim.slo_latency_s else 0.0
                             for l in window]) if window else 0.0)
            for i, inst in enumerate(instances):
                dev = cluster.device(inst.home)
                monitors[i].record(MetricsSnapshot(
                    t=t, rps=wl.rps,
                    p50_latency=_percentile(window, 50),
                    p95_latency=_percentile(window, 95),
                    slo_violation_rate=float(viol),
                    oom_events=0,
                    queue_len=len(pending),
                    device_util=[d.util_compute for d in cluster.devices],
                    device_mem_frac=[d.used_mem / d.mem_capacity
                                     for d in cluster.devices]))
                ctrl = controllers[i]
                if ctrl is not None:
                    ctrl.plan = inst.plan
                    action = ctrl.tick()
                    if action:
                        inst.plan = ctrl.plan
                        inst.batch_cap = min(inst.batch_cap,
                                             max(ctrl.batch_size, 1))
                        ctrl_log.append(f"t={t:.2f} inst{i} {action}")

    return SimResult(completed=completed, dropped=dropped,
                     oom_events=oom_events, sim_time=max(t, 1e-9),
                     controller_log=ctrl_log, peak_mem_per_device=peak_mem)
