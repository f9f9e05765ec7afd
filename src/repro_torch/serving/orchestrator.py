"""Serving orchestrator — the paper's §5 control loop closed over LIVE
paged engines, local or in other processes, behind one interface.

One Orchestrator owns N serving instances (the deployment's model
replicas) as ``serving.instance.InstanceHandle``s: a handle is either a
``LocalInstance`` (an in-process ``Engine``) or a
``remote_engine.EngineProxy`` (a real paged Engine in a CHILD PROCESS
behind the RPC wire protocol of serving/transport.py — the distributed
serving plane; ``remote=True`` or an explicit ``handles=[...]`` mix
selects the topology). The orchestrator itself contains no transport
knowledge: everything it does goes through the handle surface, so the
same control loop drives one process or a fleet. Every
``telemetry_every`` steps:

1. **telemetry**  — folds each instance's counters (block-pool vacancy,
   queue depth, per-step wall latency from
   ``serving.instrument.EngineTelemetry`` — recorded in-process for
   local instances, mirrored from the engine server's serialized
   snapshots for remote ones — SLO violations measured on finished
   requests, prefix-sharing hit rate and blocks saved) into a
   ``core.monitor.MetricsSnapshot``;
2. **decision**   — runs ``core.controller.Controller.tick()`` (Alg. 1
   scale-up on vacancy, Alg. 2 scale-down on SLO violation / pool
   pressure) against a Cluster whose devices mirror the instances.
   After a scale-down executes, the POST-ACTION snapshot is fed back
   and Alg. 2 iterates further phases within the same burst (bounded by
   ``max_phases``) instead of waiting a full tick per remediation;
3. **execution**  — applies the decision to the RUNNING instances,
   mid-decode, without draining:

   * scale-up: the plan's per-layer replication degrees go to every
     instance via ``InstanceHandle.apply_plan`` (for a remote instance
     the degree list rides an RPC frame);
   * scale-down / rebalance: KV BLOCKS of live requests migrate between
     instances' pools — OVERLAPPED and two-phase by default
     (``migrate_requests_overlapped``): a phase-1 snapshot of the
     victim's blocks streams to the destination and is staged there
     WHILE THE SOURCE KEEPS DECODING (the destination import is
     pipelined; the source steps in between), then phase 2
     pause-copies only the short dirty-set delta (blocks written since
     the snapshot, tracked by paged_kv write epochs) and resumes at the
     destination — the victim stream leaves decode rotation only for
     the delta, at most one decode step. A destination that can't hold
     the blocks re-queues the request instead of dropping it
     (deterministic counter-based replay), keeping the loop zero-drop
     by construction.

Crash recovery: a remote instance that dies (its next RPC raises
``transport.TransportClosed``) has its in-flight streams re-queued on
surviving instances from the proxy's pristine-clone mirror; replay is
deterministic, so a worker loss costs recompute, never output or drops.

The telemetry -> controller -> operation dataflow, the block-migration
wire format, and the two-phase migration timeline are documented in
DESIGN.md (§3, §4, §7).

Counterpart of ``repro.serving.orchestrator`` for the port: the same
control loop, with ``**engine_kw`` (``device`` among them) passed to
each ``Engine``, so without ``device="cpu"`` it needs a CUDA card.
In-process instances share the card, and migration moves blocks between
their pools on it; with ``remote=True`` each instance is an engine-server
process (``remote_engine.EngineProxy``) with its own CUDA context on the
same card, and the ``device`` travels in its init stream.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import migration as MIG
from repro_torch.core.cluster import Cluster, Device, layer_weight_bytes
from repro_torch.core.controller import (Controller, ControllerConfig,
                                   PodElasticityConfig)
from repro_torch.core.monitor import MetricsSnapshot, Monitor
from repro_torch.core.plan import PlacementPlan
from repro_torch.serving import faults as FLT
from repro_torch.serving import observe as OBS
from repro_torch.serving import transport as TR
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.instance import InstanceHandle, LocalInstance
from repro_torch.serving.instrument import FaultCounters
from repro_torch.serving.request import RequestSpec
from repro_torch.serving.router import (PrefixAffinityRouter, RouteDecision,
                                  RouterPolicy)


@dataclasses.dataclass
class MigrationRecord:
    """One executed live KV-block migration (bench + test evidence)."""
    rid: int
    src: int
    dst: int
    n_blocks: int
    bytes_moved: int
    seconds: float          # end-to-end wall (begin -> resumed)
    est_seconds: float
    resumed: bool           # False = destination re-queued (replay) instead
    mode: str = "stw"       # "stw" (stop-the-world) | "overlapped"
    stall_s: float = 0.0    # wall time the stream was in NO decode rotation
    delta_blocks: int = 0   # overlapped only: blocks in the phase-2 delta
    delta_bytes: int = 0


@dataclasses.dataclass
class RespawnPolicy:
    """Supervised-respawn knobs (DESIGN.md §9). A dead/quarantined
    respawnable worker is restarted after a capped exponential backoff
    (``backoff_base * 2^attempt``, at most ``backoff_cap`` seconds) and
    re-admitted through the normal two-phase bring-up handshake. The
    flap detector is a circuit breaker: ``max_failures`` failures of
    the same instance inside ``window_s`` evict it permanently —
    a crash-looping worker must not soak the fleet in bring-up cost
    forever."""
    backoff_base: float = 0.25
    backoff_cap: float = 5.0
    max_failures: int = 3
    window_s: float = 60.0
    start_timeout: float = 120.0


class Orchestrator:
    def __init__(self, cfg: ModelConfig, params, *, n_instances: int = 2,
                 max_batch: int = 4, max_len: int = 128,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 dtype="float32", slo_latency: float = 50.0,
                 telemetry_every: int = 4,
                 controller_cfg: Optional[ControllerConfig] = None,
                 link_bandwidth: float = 50e9, remote: bool = False,
                 handles: Optional[List[InstanceHandle]] = None,
                 max_phases: int = 3,
                 rpc_deadline: Optional[float] = None,
                 respawn_policy: Optional[RespawnPolicy] = None,
                 router: Optional[RouterPolicy] = None,
                 max_queue: Optional[int] = None,
                 worker_factory=None,
                 pod_cfg: Optional[PodElasticityConfig] = None,
                 tracer: Optional[OBS.Tracer] = None,
                 flightrec_path: Optional[str] = None,
                 **engine_kw):
        self.cfg = cfg
        # observability plane (serving/observe.py): the tracer is opt-in
        # (the ingress installs one, or tests pass it); the flight
        # recorder is ALWAYS on — a bounded ring of control-plane
        # decisions is cheap and is exactly the thing you need after
        # the incident you didn't plan for
        self.tracer = tracer
        self.flightrec = OBS.FlightRecorder(capacity=512,
                                            dump_path=flightrec_path)
        self.slo_latency = slo_latency
        self.telemetry_every = telemetry_every
        self.link_bandwidth = link_bandwidth
        self.max_phases = max_phases
        # routing policy (serving/router.py): prefix-affinity by default
        # — falls back to the historical vacancy order when no chain
        # matches, so non-shared workloads route exactly as before
        self.router = router if router is not None else PrefixAffinityRouter()
        # per-instance admission ceiling for the ingress (None = no
        # backpressure; route() returns None -> HTTP 429 + Retry-After)
        self.max_queue = max_queue
        # pod elasticity: a factory (idx -> InstanceHandle) arms
        # grow_pod; pod_cfg arms the controller's pod decisions
        self.worker_factory = worker_factory
        self.pod_cfg = pod_cfg
        if handles is not None:
            self.instances: List[InstanceHandle] = list(handles)
        elif remote:
            from repro_torch.serving.remote_engine import EngineProxy
            self.instances = [
                EngineProxy(cfg, params, max_batch=max_batch,
                            max_len=max_len, dtype=dtype,
                            block_size=block_size, n_blocks=n_blocks,
                            **engine_kw)
                for _ in range(n_instances)]
        else:
            self.instances = [
                LocalInstance(Engine(cfg, params, max_batch=max_batch,
                                     max_len=max_len, dtype=dtype,
                                     cache_kind="paged",
                                     block_size=block_size,
                                     n_blocks=n_blocks, **engine_kw))
                for _ in range(n_instances)]
        assert self.instances, "need at least one instance"
        n_instances = len(self.instances)
        self.telemetry = [h.telemetry for h in self.instances]
        self._preempt_seen = [0] * n_instances

        # one Device per live instance; capacity = its pool + headroom for
        # layer replicas so Alg. 1's free-mem gate has room to say yes
        pool_bytes = self.instances[0].pool_bytes()
        mb = self.instances[0].max_batch
        ccfg = controller_cfg or ControllerConfig(
            replica_size=layer_weight_bytes(cfg, dtype_bytes=4))
        if ccfg.module_bytes is None:
            # REAL footprints for scale-down destination fitting: a
            # kv_cache migrant is one slot's share of the live pool
            rs = ccfg.replica_size
            ccfg = dataclasses.replace(
                ccfg, module_bytes={
                    "layer": rs, "attn": rs / 3, "ffn": 2 * rs / 3,
                    "kv_cache": pool_bytes / max(mb, 1)})
        self._ccfg = ccfg   # kept: grow_pod sizes new Devices from it
        cap = pool_bytes + 2 * cfg.num_layers * ccfg.replica_size
        self.cluster = Cluster(
            devices=[Device(i, mem_capacity=cap, compute_flops=1.0)
                     for i in range(n_instances)],
            link_bandwidth=link_bandwidth)
        self.plan = PlacementPlan.initial(cfg.num_layers)
        self.monitor = Monitor()
        self.controller = Controller(
            ccfg, self.cluster, self.plan, self.monitor,
            batch_size=mb,
            # the live loop can't re-measure inside ONE scale_down call;
            # instead control_tick feeds the post-action snapshot back
            # and iterates Alg. 2's phases across the same burst
            is_violating=lambda plan, bs: False,
            on_plan_change=self._on_plan_change,
            pod_cfg=pod_cfg)
        self.finished: List[Request] = []
        self.migrations: List[MigrationRecord] = []
        self.recoveries: List[dict] = []    # crash-recovery audit trail
        self.dropped = 0                    # never incremented: zero-drop
        self._tick = 0
        self._home: Dict[int, int] = {}     # rid -> instance
        self._recovered: set = set()        # instances already recovered
        # --- pod elasticity state (DESIGN.md §11) ---
        # indices deliberately drained + reaped by shrink_pod. Index
        # slots are NEVER reused or shifted (_home/_respawn/_evicted are
        # idx-keyed); a retired slot just goes dark everywhere.
        self._retired: set = set()
        self._grown_at: Dict[int, float] = {}   # idx -> monotonic birth
        self.pod_log: List[dict] = []           # grow/shrink audit trail
        # rid -> longest token list observed for slot-holding streams
        # (the ingress feed; full lists make migration overlap and
        # crash replay idempotent — longest == most progressed)
        self._stream_acc: Dict[int, List[int]] = {}
        # finishes collected by migrate_requests_overlapped's internal
        # overlap steps: already in self.finished, surfaced through the
        # NEXT step()'s return so run_until_done callers never miss one
        self._orphans: List[Request] = []
        # control-plane accounting for the batched poll (benchmarks):
        # ticks   = _step_all invocations,
        # polls   = multiplexed drains issued (1 per tick with any
        #           remote instance — the "one poll per tick" invariant),
        # step_rpcs = step RPCs fanned out across those polls
        self.rpc_stats = {"ticks": 0, "polls": 0, "step_rpcs": 0}
        # --- failure domain (DESIGN.md §9) ---
        self.faults = FaultCounters()
        self.respawn_policy = respawn_policy
        self._respawn: Dict[int, dict] = {}   # idx -> supervisor state
        self._evicted: set = set()            # flap-detector removals
        self.respawn_log: List[dict] = []     # audit trail (bench/tests)
        # cold-start grace: a respawned replica's first ACTIVE step may
        # include XLA compiles that dwarf any sane RPC deadline — its
        # deadline stays disarmed until that step completes, so a fresh
        # worker is never misclassified as hung while it warms up
        self._grace: set = set()
        self._fanout_t = 0.0                  # last control fan-out start
        self.rpc_deadline: Optional[float] = None
        self.set_rpc_deadline(rpc_deadline)

    def set_rpc_deadline(self, seconds: Optional[float]):
        """Arm (or disarm, with None — the default: zero behavior
        change) the per-call deadline on every instance handle. With a
        deadline set, a hung peer resolves to a ``hung`` poll entry in
        at most ``seconds`` and is then classified by a heartbeat probe
        bounded by the same budget — detection wall ≤ 2x the deadline,
        never an unbounded control-tick stall."""
        self.rpc_deadline = seconds
        for i, h in enumerate(self.instances):
            if i not in self._grace:    # warming replicas arm later
                h.set_rpc_deadline(seconds)

    # ------------------------------------------------------------ topology
    @property
    def engines(self) -> List[Engine]:
        """The raw in-process Engines (tests / single-host tooling).
        Remote instances have no local engine — use the handle surface."""
        return [h.engine for h in self.instances
                if isinstance(h, LocalInstance)]

    def _alive(self) -> List[int]:
        return [i for i, h in enumerate(self.instances)
                if i not in self._retired and h.alive()]

    def clock(self) -> float:
        alive = self._alive()
        return self.instances[alive[0]].clock() if alive else 0.0

    def close(self):
        for h in self.instances:
            try:
                h.close()
            except TR.TransportError:
                pass

    # -------------------------------------------------------------- intake
    def submit(self, spec: RequestSpec):
        """Route through the policy (serving/router.py — default:
        prefix-affinity on the prompt's content-chain keys, falling back
        to most free pool blocks / shortest queue / lowest id) and admit.
        Takes the construction-time ``RequestSpec`` — the chosen
        instance's engine mints the mutable ``Request``.

        A routed peer that fails DURING the submit (died, or hung past
        its deadline) does not lose the request: the handle mirrors the
        pristine clone before sending, so failing the peer replays the
        clone — with everything else it held — onto a survivor."""
        self.submit_to(self._route(spec=spec), spec)

    def submit_to(self, idx: int, spec: RequestSpec):
        """Admit on a SPECIFIC instance — the ingress routes on its own
        thread (``route``) and hands (idx, spec) to the pump, which must
        not re-route; bookkeeping and failure handling stay here either
        way."""
        self._home[spec.rid] = idx
        # trace context rides the submit itself (piggybacked on the RPC
        # frame for a remote instance) so engine-side spans record from
        # the request's very first hook
        trace = self.tracer.ctx(spec.rid) if self.tracer else None
        t_obs = time.monotonic()
        try:
            # positional call when untraced: handle subclasses predating
            # the trace kwarg (tests stub the surface) keep working
            if trace is None:
                self.instances[idx].submit(spec)
            else:
                self.instances[idx].submit(spec, trace=trace)
        except (TR.TransportClosed, TR.RpcTimeout) as e:
            self._fail_instance(idx, hung=isinstance(e, TR.RpcTimeout),
                                t_obs=t_obs)

    def route(self, spec: Optional[RequestSpec] = None, prompt=None,
              pending: Optional[Dict[int, int]] = None
              ) -> Optional[RouteDecision]:
        """Admission-checked routing for the ingress: the policy's full
        verdict, or None when every alive instance is at ``max_queue``
        (counting ``pending`` — accepted-but-not-yet-submitted requests)
        — the HTTP 429 + Retry-After signal. The ``spec`` makes the
        verdict class-aware (batch traffic is shed one seat early).
        Reads only cached gauges: safe to call off the orchestrator's
        thread."""
        alive = self._alive()
        if not alive:
            self.flightrec.record("route", verdict="no-alive-instance")
            return None
        d = self.router.select(self.instances, alive, spec=spec,
                               prompt=prompt,
                               pending=pending, max_queue=self.max_queue)
        if d is None:
            self.flightrec.record("route", verdict="shed",
                                  alive=len(alive),
                                  max_queue=self.max_queue)
        else:
            self.flightrec.record("route", verdict="admit",
                                  **d.as_event())
        return d

    def _route(self, among: Optional[List[int]] = None,
               prompt=None, spec=None) -> int:
        cands = among if among is not None else self._alive()
        assert cands, "no alive instance to route to"
        return self.router.select(self.instances, cands,
                                  spec=spec, prompt=prompt).idx

    # ------------------------------------------------------------ main loop
    def _step_all(self) -> List[Request]:
        """Step every alive instance through ONE batched control-plane
        poll: the step request fans out to all of them via
        ``step_async`` (remote servers start computing concurrently; a
        local handle executes inline during the fan-out), then a single
        ``transport.drain_pendings`` wait collects the replies as they
        land — per-tick wall time is bounded by the SLOWEST instance's
        step, not the sum of N sequential round trips. Crash detection
        folds into the same poll: a ``closed`` entry (the instance died
        before replying) triggers the same idempotent re-queue + replay
        path as a TransportClosed raised anywhere else."""
        fin: List[Request] = []
        idxs: List[int] = []
        pendings: List = []
        self._fanout_t = time.monotonic()
        for i, h in enumerate(self.instances):
            if i in self._retired:
                continue       # deliberately reaped: nothing to step
            if not h.alive():
                if i not in self._recovered:
                    # died silently since the last tick (nothing raised
                    # TransportClosed because no op was in flight — e.g.
                    # a SIGKILLed worker): same replay path, same
                    # idempotency guard
                    self.handle_instance_failure(i)
                continue
            try:
                pendings.append(h.step_async())
            except TR.TransportClosed:
                self.handle_instance_failure(i)
                continue
            idxs.append(i)
        if not pendings:
            return fin
        n_remote = sum(isinstance(p, TR.Pending) for p in pendings)
        self.rpc_stats["ticks"] += 1
        self.rpc_stats["step_rpcs"] += n_remote
        if n_remote:
            self.rpc_stats["polls"] += 1
        errors = []
        for (i, p), (status, val) in zip(zip(idxs, pendings),
                                         TR.drain_pendings(pendings)):
            h = self.instances[i]
            if status == "closed":
                h.mark_dead()
                self.handle_instance_failure(i)
            elif status == "hung":
                try:
                    fin.extend(self._on_hung_step(i, p))
                except TR.RemoteError as e:
                    errors.append(e)   # salvaged reply was an error reply
            elif status == "error":
                # don't raise yet: later entries hold other instances'
                # ALREADY-RECEIVED step replies — skipping finish_step
                # would lose their finished requests and desync the
                # inflight mirrors crash replay depends on
                errors.append(val)
            else:
                fin.extend(h.finish_step(val))
                if i in self._grace and h.active_count():
                    # first step with real work done: compiles are paid,
                    # the replica now answers on normal latency — arm it
                    h.set_rpc_deadline(self.rpc_deadline)
                    self._grace.discard(i)
        if errors:
            # this tick's finishes must survive the raise too — the
            # callers' extend never runs, so route them through the
            # orphan path the overlap steps already use
            self.finished.extend(fin)
            self._orphans.extend(fin)
            raise errors[0]
        return fin

    def _on_hung_step(self, idx: int, pending) -> List[Request]:
        """A step RPC missed its deadline with the socket still open.
        Classify with the heartbeat probe (bounded by the same deadline
        budget, so total detection wall stays ≤ 2x the deadline):

        * ``alive``  — the peer answers. In-order serving then proves
          one of two things: the step reply already arrived while we
          probed (merely-slow peer — salvage it, nothing was lost), or
          the step REQUEST frame itself was lost (injected drop /
          healed partition) and the step never executed — skipping this
          tick is safe, the peer stays admitted;
        * ``hung``   — heartbeat unanswered too: blackholed/half-open.
          Quarantine (sever + kill) and replay its inflight mirror;
        * ``dead``   — it died while we looked: normal crash path."""
        self.faults.rpc_timeouts += 1
        h = self.instances[idx]
        verdict = h.probe(self.rpc_deadline or 1.0)
        if verdict == "alive":
            if pending.ready():
                return h.finish_step(pending.wait())
            return []
        self._fail_instance(idx, hung=(verdict == "hung"))
        return []

    def _fail_instance(self, idx: int, *, hung: bool,
                       t_obs: Optional[float] = None):
        """Fold one observed peer failure into quarantine + replay. A
        HUNG peer is quarantined first (socket severed, owned process
        killed) so the idempotent replay can never race a zombie's late
        effects; a dead one just gets marked. ``t_obs`` is when the
        failing call was issued — the start of the observation window
        for the detection-latency gauge; callers classifying outside
        the step fan-out (submit, migration RPCs, recovery replay) must
        pass it, else the gauge would charge this peer with wall time
        from before it was even observable as faulty."""
        h = self.instances[idx]
        if hung and idx not in self._recovered:
            self.faults.quarantines += 1
            self.flightrec.record("quarantine", instance=idx)
            try:
                h.quarantine()
            except TR.TransportError:
                pass
        else:
            h.mark_dead()
        self.handle_instance_failure(idx, reason="hung" if hung
                                     else "dead", t_obs=t_obs)

    def step(self) -> List[Request]:
        """One orchestrator iteration: step every alive instance through
        the batched poll (each records real wall latency into its
        telemetry), collect finishes, recover any instance whose
        transport died, and on telemetry ticks run the monitor ->
        controller -> execute pipeline."""
        self._tick_respawns()
        fin = self._step_all()
        self.finished.extend(fin)
        self._tick += 1
        if self._tick % self.telemetry_every == 0:
            self.control_tick()
        out = self._drain_orphans() + fin
        self._collect_streams(out)
        self._collect_spans(out)
        return out

    def _collect_spans(self, fin: List[Request]):
        """Drain each instance's engine-recorded spans into the tracer
        (remote handles buffer them off the step replies, already
        skew-corrected onto this clock), then close the trace of every
        request that finished this step — AFTER the drain, so a finish's
        own decode/finish spans ride the same reply and land in the tree
        before the root closes."""
        if self.tracer is None:
            return
        for i in self._alive():
            spans = self.instances[i].drain_spans()
            if spans:
                self.tracer.ingest(spans)
        for r in fin:
            # SLO attainment rides the root span: class + deadline are
            # echoed, and the tracer stamps deadline_met from the root's
            # own wall-clock extent at close time
            self.tracer.finish(r.rid, instance=self._home.get(r.rid),
                               tokens=len(r.generated),
                               slo_class=getattr(r, "slo_class",
                                                 "standard"),
                               deadline_ms=getattr(r, "deadline_ms",
                                                   None))

    # ------------------------------------------------------ token streams
    def _collect_streams(self, fin: List[Request]):
        """Fold every instance's per-step stream feed into the rid ->
        tokens accumulator the ingress flushes from. Keeping the LONGEST
        list seen makes the fold idempotent under migration overlap
        (source and destination may both report the stream for a step)
        and under crash replay (a restarted stream re-emits a prefix of
        itself — token-identical replay means longest == truth).
        Finished rids leave the accumulator: their full token lists
        travel on the finished Request objects."""
        for i in self._alive():
            for rid, toks in self.instances[i].stream_view().items():
                cur = self._stream_acc.get(rid)
                if cur is None or len(toks) > len(cur):
                    self._stream_acc[rid] = list(toks)
        for r in fin:
            self._stream_acc.pop(r.rid, None)

    def stream_view(self) -> Dict[int, List[int]]:
        """rid -> tokens generated so far for every LIVE stream, as of
        the last step — consumers (the ingress pump) keep a per-rid
        high-water mark and flush only the tail."""
        return self._stream_acc

    def _drain_orphans(self) -> List[Request]:
        """Finishes collected inside migrate_requests_overlapped's
        overlap steps (already in ``self.finished``), handed to the next
        step()/run_until_done() return so no caller misses one."""
        out, self._orphans = self._orphans, []
        return out

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        out: List[Request] = self._drain_orphans()
        steps = 0
        while steps < max_steps and any(
                self.instances[i].queue_len()
                or self.instances[i].active_rids()
                for i in self._alive()):
            out.extend(self.step())
            steps += 1
        return out

    # ------------------------------------------------------------ telemetry
    def snapshot(self) -> MetricsSnapshot:
        """Fold live instance counters into the Monitor's schema. All
        quantities are measured, none synthetic: utilization is occupied
        decode slots, memory is pool blocks in use (shared blocks counted
        ONCE — prefix sharing directly inflates the vacancy signal the
        controller scales on, with prefix_hit_rate/blocks_saved gauges
        saying how much), latency/SLO come from finished requests'
        engine-clock timestamps. A dead instance reports full/busy so the
        controller neither targets it nor counts it as vacancy."""
        util, memf, vac = [], [], []
        new_preempts = 0
        for i, h in enumerate(self.instances):
            if i in self._retired:
                # deliberately reaped: a None entry keeps the per-device
                # lists index-aligned with the cluster Devices without
                # poisoning the fleet vacancy averages forever (unlike a
                # dead instance, a retired one is never coming back)
                util.append(None)
                memf.append(None)
                vac.append(None)
                continue
            if not h.alive():
                util.append(1.0)
                memf.append(1.0)
                vac.append(0.0)
                continue
            util.append(h.active_count() / h.max_batch)
            used = h.blocks_in_use() / h.n_blocks
            memf.append(used)
            vac.append(1.0 - used)
            n = h.preempt_count()
            new_preempts += n - self._preempt_seen[i]
            self._preempt_seen[i] = n
            ps = h.prefix_stats()
            h.telemetry.record_prefix(ps["queries"], ps["hits"],
                                      ps["blocks_saved_now"])
        # fleet sharing gauges are READ BACK from the telemetry mirrors
        # just written — EngineTelemetry is the metrics source of record.
        # Folds cover ALIVE instances only: a dead worker's frozen mirror
        # (e.g. a pinned SLO-violation rate) must not drive the
        # controller after its streams were replayed elsewhere.
        tel = [self.telemetry[i] for i in self._alive()]
        pq = sum(t.prefix_queries for t in tel)
        ph = sum(t.prefix_hits for t in tel)
        saved = sum(t.blocks_saved for t in tel)
        lats = [t.latency_quantile(0.5) for t in tel]
        tps = sum(t.tokens_per_s() for t in tel)
        viol = [t.slo_violation_rate(self.slo_latency) for t in tel]
        # budget utilization averages over BUDGETED engines only — a
        # phase-scheduled instance has no budget to pack and would drag
        # the fleet gauge toward zero
        buds = [t.budget_utilization() for t in tel if t.budget]
        return MetricsSnapshot(
            t=self.clock(),
            tokens_per_s=tps,
            p50_latency=max(lats) if lats else 0.0,
            p95_latency=max((t.latency_quantile(0.95) for t in tel),
                            default=0.0),
            slo_violation_rate=max(viol) if viol else 0.0,
            queue_len=sum(self.instances[i].queue_len()
                          for i in self._alive()),
            device_util=util, device_mem_frac=memf, block_vacancy=vac,
            step_seconds=max((t.mean_step_s() for t in tel), default=0.0),
            preemptions=new_preempts,
            prefix_hit_rate=ph / pq if pq else 0.0,
            blocks_saved=saved,
            budget_utilization=(sum(buds) / len(buds) if buds else 0.0),
            ttft_p50=max((t.ttft_quantile(0.5) for t in tel),
                         default=0.0),
            ttft_p95=max((t.ttft_quantile(0.95) for t in tel),
                         default=0.0),
            queue_delay_p95=max((t.queue_delay_quantile(0.95)
                                 for t in tel), default=0.0),
            faults_injected=FLT.injected_total(),
            rpc_timeouts=self.faults.rpc_timeouts,
            quarantines=self.faults.quarantines,
            respawns=self.faults.respawns,
            pod_size=len(self._alive()))

    def _sync_cluster(self, snap: MetricsSnapshot):
        for d, u, m in zip(self.cluster.devices, snap.device_util,
                           snap.device_mem_frac):
            if u is None:     # retired slot: full + idle, never a target
                d.util_compute = 0.0
                d.used_mem = d.mem_capacity
                continue
            h = self.instances[d.device_id]
            pool = h.pool_bytes() if h.alive() else d.mem_capacity
            d.util_compute = u
            d.used_mem = m * pool

    # ------------------------------------------------------------- control
    def control_tick(self, max_phases: Optional[int] = None
                     ) -> Optional[str]:
        """One monitor -> controller -> execute BURST (also callable
        directly by tests/benchmarks to inject a decision point).

        Scale-down iterates: after executing a remediation, the
        post-action MetricsSnapshot — which already reflects the moved
        blocks, queue handoffs and cleared preemption pressure — is fed
        back into the Controller and Alg. 2 runs another phase within
        the same burst, until it stops demanding one, a phase moves
        nothing, or ``max_phases`` is hit. This is the live analogue of
        Alg. 2's "re-check after each phase": measure, act, re-measure —
        not one optimistic remediation per tick."""
        phases = self.max_phases if max_phases is None else max_phases
        last = None
        for phase in range(phases):
            snap = self.snapshot()
            self.controller.observe(snap)
            self._sync_cluster(snap)
            action = self.controller.tick(in_burst=phase > 0)
            # every verdict — including "no action" — lands in the
            # flight recorder WITH the inputs that produced it, so a
            # post-incident reader sees why the controller did nothing
            self.flightrec.record(
                "controller", phase=phase, action=action,
                inputs={"slo_violation_rate": snap.slo_violation_rate,
                        "queue_len": snap.queue_len,
                        "tokens_per_s": snap.tokens_per_s,
                        "vacancy": self.monitor.vacancy_rate(),
                        "block_vacancy": self.monitor.block_vacancy_rate(),
                        "pool_pressure": self.monitor.pool_pressure(),
                        "budget_utilization": snap.budget_utilization,
                        "pod_size": snap.pod_size})
            if action:
                last = action
            if not (action and action.startswith("scale-down")):
                break
            if self._execute_scale_down() == 0:
                break       # nothing left to move: the burst is done
        self.plan = self.controller.plan
        pod_action = self._pod_tick()
        return last or pod_action

    # -------------------------------------------------- pod elasticity
    def pod_size(self) -> int:
        """Alive, non-retired instances — the controller's population."""
        return len(self._alive())

    def _pod_tick(self) -> Optional[str]:
        """Consult the controller's pod-level decision (armed by
        ``worker_factory`` + ``pod_cfg``) and execute it: grow spawns a
        worker through the factory; shrink drains the cheapest eligible
        worker through the zero-drop migration path, then reaps it."""
        if self.worker_factory is None or self.pod_cfg is None:
            return None
        target = self._shrink_target()
        decision = self.controller.pod_tick(
            self.pod_size(),
            est_drain_s=target[1] if target else 0.0)
        if decision:
            self.flightrec.record(
                "pod_decision", decision=decision,
                pod_size=self.pod_size(),
                target=target[0] if target else None,
                est_drain_s=target[1] if target else 0.0)
        if decision == "grow":
            idx = self.grow_pod()
            return f"grow-pod[{idx}]" if idx is not None else None
        if decision == "shrink" and target is not None:
            idx = self.shrink_pod(target[0])
            return f"shrink-pod[{idx}]" if idx is not None else None
        return None

    def grow_pod(self) -> Optional[int]:
        """Spawn ONE fresh instance through the worker factory and admit
        it to the plane: handle + telemetry + a cluster Device sized by
        the same capacity formula as the launch-time fleet. The router
        starts steering to it immediately (it has the most free blocks
        in the pod); under an armed RPC deadline it gets the same
        cold-start grace as a respawned replica. Returns the new index,
        or None when the factory is absent or the pod is at its max."""
        if self.worker_factory is None:
            return None
        if (self.pod_cfg is not None
                and self.pod_size() >= self.pod_cfg.max_instances):
            return None
        idx = len(self.instances)
        h = self.worker_factory(idx)
        self.instances.append(h)
        self.telemetry.append(h.telemetry)
        self._preempt_seen.append(0)
        cap = (h.pool_bytes()
               + 2 * self.cfg.num_layers * self._ccfg.replica_size)
        self.cluster.devices.append(
            Device(idx, mem_capacity=cap, compute_flops=1.0))
        if any(d != 1 for d in self.plan.p):
            h.apply_plan(list(self.plan.p))   # adopt the live plan
        if self.rpc_deadline is not None:
            # cold-start grace (same as respawn): arm the deadline only
            # after its first completed ACTIVE step
            h.set_rpc_deadline(None)
            self._grace.add(idx)
        self._grown_at[idx] = time.monotonic()
        self.pod_log.append({"event": "grow", "instance": idx,
                             "pod_size": self.pod_size()})
        self.flightrec.record("pod_grow", instance=idx,
                              pod_size=self.pod_size())
        return idx

    def _shrink_candidates(self) -> List[int]:
        """Instances eligible for reaping: alive, warmed up (not in
        cold-start grace — flap protection: a grow immediately followed
        by a shrink must not orphan a BOOTING worker), and older than
        the flap-guard window."""
        now = time.monotonic()
        guard = self.pod_cfg.flap_guard_s if self.pod_cfg else 0.0
        return [i for i in self._alive()
                if i not in self._grace
                and now - self._grown_at.get(i, float("-inf")) >= guard]

    def _shrink_target(self) -> Optional[tuple]:
        """(index, estimated drain seconds) of the cheapest eligible
        shrink victim — the cost the controller's Table-2-style gate
        prices — or None when the pod cannot shrink."""
        floor = self.pod_cfg.min_instances if self.pod_cfg else 1
        if len(self._alive()) <= max(floor, 1):
            return None
        cands = self._shrink_candidates()
        if not cands:
            return None
        idx = min(cands, key=lambda i: (self.instances[i].active_count(),
                                        self.instances[i].queue_len(),
                                        -i))
        h = self.instances[idx]
        per_block = h.pool_bytes() / max(h.n_blocks, 1)
        est = MIG.estimate_cost(h.blocks_in_use() * per_block,
                                self.link_bandwidth)
        return idx, est

    def shrink_pod(self, idx: Optional[int] = None) -> Optional[int]:
        """Drain instance ``idx`` (default: the cheapest eligible
        victim) through the existing zero-drop path — queue handoff,
        then overlapped KV-block migration of its active streams — and
        RETIRE it: close the handle, keep the index slot dark forever
        (indices are never reused; _home/_respawn/_evicted are
        idx-keyed). Returns the reaped index, or None when the pod is at
        its floor or the victim is ineligible (booting / flap-guarded).
        """
        floor = self.pod_cfg.min_instances if self.pod_cfg else 1
        if len(self._alive()) <= max(floor, 1):
            return None
        cands = self._shrink_candidates()
        if idx is None:
            if not cands:
                return None
            idx = min(cands,
                      key=lambda i: (self.instances[i].active_count(),
                                     self.instances[i].queue_len(), -i))
        elif idx not in cands:
            return None
        self.drain_instance(idx)
        self._retire_instance(idx)
        return idx

    def _retire_instance(self, idx: int):
        """Take a DRAINED instance out of the plane for good. Also
        registered in ``_recovered``: a deliberate removal must never be
        mistaken for a crash (its streams were migrated, not lost — a
        replay would duplicate them)."""
        self._retired.add(idx)
        self._recovered.add(idx)
        self._grace.discard(idx)
        self._respawn.pop(idx, None)   # a reaped slot is never respawned
        self._grown_at.pop(idx, None)
        try:
            self.instances[idx].close()
        except TR.TransportError:
            pass
        self.pod_log.append({"event": "shrink", "instance": idx,
                             "pod_size": self.pod_size()})
        self.flightrec.record("pod_shrink", instance=idx,
                              pod_size=self.pod_size())

    def _on_plan_change(self, plan: PlacementPlan, batch_size: int):
        """Controller callback: push the new replication degrees to every
        LIVE instance — the next decode step of each engine runs under
        the plan's per-layer batch sharding, no drain, no restart (for a
        remote instance the degree list travels as an RPC frame)."""
        self.plan = plan
        for i in self._alive():
            self.instances[i].apply_plan(list(plan.p))

    def _execute_scale_down(self) -> int:
        """Realize the controller's Phase-1 module migrations as KV-block
        transfers: whatever module the plan nominally moves, what a live
        instance can shed mid-decode is the memory-intensive module —
        its requests' paged KV (§3.3's preferred migrant). One rebalance
        per (src, dst) pair per phase, each OVERLAPPED (the source keeps
        decoding while the bulk snapshot stages at the destination).
        Returns the number of requests actually moved — the feedback
        signal ``control_tick``'s burst iteration keys on."""
        res = self.controller.last_scale_down
        if res is None:
            return 0
        seen = set()
        moved = 0
        for layer, comp, src, dst in res.migrations:
            if (src, dst) in seen or src == dst:
                continue
            if not (self.instances[src].alive()
                    and self.instances[dst].alive()):
                continue
            seen.add((src, dst))
            moved += len(self.migrate_requests_overlapped(src, dst))
        return moved

    # ------------------------------------------------------------ migration
    def migrate_requests(self, src: int, dst: int,
                         max_requests: Optional[int] = None
                         ) -> List[MigrationRecord]:
        """STOP-THE-WORLD migration (the baseline the overlapped path is
        benchmarked against): pause, ship everything, resume — the
        victim stream is out of decode rotation for the full transfer.
        Never drops: a request the destination pool can't hold is
        re-queued there and replays deterministically (counter-based
        sampling keys). Requests holding SHARED (refcounted) blocks
        migrate safely: the export materializes shared content into the
        payload and carries the prefix keys, so the stream stays
        token-identical and the destination's prefix cache learns the
        migrated prompt."""
        hsrc, hdst = self.instances[src], self.instances[dst]
        slots = sorted(hsrc.active_rids().keys())
        if max_requests is not None:
            slots = slots[:max_requests]
        out: List[MigrationRecord] = []
        for slot in slots:
            t0 = time.perf_counter()
            t_hop0 = OBS.server_now()
            t_obs = time.monotonic()
            try:
                payload = hsrc.pause_request(slot)
            except (TR.TransportClosed, TR.RpcTimeout) as e:
                # source died or hung mid-pause: either way its inflight
                # mirror (which still holds this stream — pause never
                # returned) replays on survivors
                self._fail_instance(src, hung=isinstance(e, TR.RpcTimeout),
                                    t_obs=t_obs)
                break
            req = payload["request"]
            # the destination must know the trace BEFORE the resume so
            # its engine records the continuation's spans (the explicit
            # registration path — no submit frame to piggyback on)
            self._register_trace_on(dst, req.rid)
            t_obs = time.monotonic()
            try:
                ok = hdst.resume_request(payload)
                if not ok:
                    hdst.requeue_front(req)  # zero-drop fallback: replay
            except (TR.TransportClosed, TR.RpcTimeout) as e:
                # destination died/hung AFTER the source detached the
                # stream: the payload in hand is the only copy — hand it
                # back to the (alive) source for deterministic replay,
                # then recover whatever else the destination held. A
                # HUNG destination is quarantined (killed) before the
                # replay, so even if it did import the payload it can
                # never decode it — no duplicated stream.
                if hsrc.alive():
                    hsrc.requeue_front(req)
                self._fail_instance(dst, hung=isinstance(e, TR.RpcTimeout),
                                    t_obs=t_obs)
                break
            dt = time.perf_counter() - t0
            nbytes = payload["kv"]["nbytes"]
            rec = MigrationRecord(
                rid=req.rid, src=src, dst=dst,
                n_blocks=len(payload["kv"]["cols"]),
                bytes_moved=nbytes, seconds=dt,
                est_seconds=MIG.estimate_cost(nbytes, self.link_bandwidth),
                resumed=ok, mode="stw", stall_s=dt)
            self._home[req.rid] = dst
            self.migrations.append(rec)
            self._record_migration(rec, t_hop0)
            out.append(rec)
        return out

    def _register_trace_on(self, idx: int, rid: int):
        """Re-associate a live trace with its rid on instance ``idx``
        (migration landing, crash replay). Best-effort: a transport
        failure here surfaces on the very next real op, which owns the
        recovery — tracing must never alter the control flow."""
        if self.tracer is None:
            return
        ctx = self.tracer.ctx(rid)
        if ctx is None:
            return
        try:
            self.instances[idx].register_trace(ctx)
        except (TR.TransportClosed, TR.RpcTimeout):
            pass

    def _record_migration(self, rec: MigrationRecord, t_hop0: float):
        """One executed migration -> a flight-recorder event (phase
        timings included) and, when the stream is traced, a
        ``migration_hop`` span parented under its request root."""
        self.flightrec.record(
            "migration", rid=rec.rid, src=rec.src, dst=rec.dst,
            mode=rec.mode, resumed=rec.resumed, n_blocks=rec.n_blocks,
            bytes_moved=rec.bytes_moved, seconds=rec.seconds,
            stall_s=rec.stall_s, delta_blocks=rec.delta_blocks,
            delta_bytes=rec.delta_bytes)
        if self.tracer is not None:
            self.tracer.span(
                rec.rid, "migration_hop", t_hop0, OBS.server_now(),
                origin="orchestrator",
                attrs={"src": rec.src, "dst": rec.dst, "mode": rec.mode,
                       "stall_s": rec.stall_s, "resumed": rec.resumed})

    def begin_migration(self, src: int, dst: int, slot: int) -> dict:
        """Phase 1 of an overlapped migration: snapshot the victim's
        blocks at the source WITHOUT pausing it, and pipeline the staging
        import at the destination (``prepare_resume_async`` — for a
        remote destination the import runs in its process while this one
        keeps stepping the source). Returns the migration ticket for
        ``finish_migration``."""
        hsrc, hdst = self.instances[src], self.instances[dst]
        t0 = time.perf_counter()
        snap = hsrc.snapshot_request(slot)
        pending = hdst.prepare_resume_async(snap)
        return {"src": src, "dst": dst, "slot": slot, "rid": snap["rid"],
                "epoch": snap["epoch"], "pending": pending,
                "snap_blocks": len(snap["kv"]["cols"]),
                "snap_bytes": snap["kv"]["nbytes"], "t0": t0,
                "t_hop0": OBS.server_now()}

    def finish_migration(self, ticket: dict) -> Optional[MigrationRecord]:
        """Phase 2: pause the victim, ship ONLY the dirty-set delta
        (blocks written since the phase-1 snapshot), commit at the
        destination, rotate the stream back in. The stream is out of
        decode rotation exactly for this window (``stall_s``). Falls
        back zero-drop at every exit: source finished/preempted the
        stream meanwhile -> abort staging; staging failed or the commit
        can't fit -> full re-queue + deterministic replay; a transport
        death -> crash recovery. Returns None when there was nothing
        left to move."""
        src, dst, slot = ticket["src"], ticket["dst"], ticket["slot"]
        hsrc, hdst = self.instances[src], self.instances[dst]
        t_obs = time.monotonic()
        try:
            staged = ticket["pending"].wait()
        except (TR.TransportClosed, TR.RpcTimeout) as e:
            self._fail_instance(dst, hung=isinstance(e, TR.RpcTimeout),
                                t_obs=t_obs)
            return None
        if hsrc.active_rids().get(slot) != ticket["rid"]:
            # finished or preempted at the source in the meantime: its
            # tokens/queue entry live there — nothing to move, but the
            # staged slots at the destination must be reclaimed
            if staged is not None:
                t_obs = time.monotonic()
                try:
                    hdst.abort_resume(staged)
                except (TR.TransportClosed, TR.RpcTimeout) as e:
                    self._fail_instance(
                        dst, hung=isinstance(e, TR.RpcTimeout),
                        t_obs=t_obs)
            return None
        # Each failure window below is handled per-peer so a fault
        # injected ANYWHERE between pause_request and commit_resume
        # leaves the source authoritative and the staged destination
        # slots reclaimed (by abort, or with the quarantined process).
        payload = None
        t_pause = time.perf_counter()
        t_obs = time.monotonic()
        try:
            if staged is None:
                # destination couldn't stage the bulk: classic path
                payload = hsrc.pause_request(slot)
            else:
                payload = hsrc.pause_request(slot,
                                             since_epoch=ticket["epoch"])
        except (TR.TransportClosed, TR.RpcTimeout) as e:
            # the SOURCE failed mid-pause: pause never returned, so its
            # inflight mirror still holds the stream — replay covers
            # it. Reclaim the staged slots at the (alive) destination.
            if staged is not None and hdst.alive():
                t_abort = time.monotonic()
                try:
                    hdst.abort_resume(staged)
                except (TR.TransportClosed, TR.RpcTimeout) as e2:
                    self._fail_instance(
                        dst, hung=isinstance(e2, TR.RpcTimeout),
                        t_obs=t_abort)
            self._fail_instance(src, hung=isinstance(e, TR.RpcTimeout),
                                t_obs=t_obs)
            return None
        self._register_trace_on(dst, ticket["rid"])
        t_obs = time.monotonic()
        try:
            if staged is None:
                ok = hdst.resume_request(payload)
            else:
                ok = hdst.commit_resume(staged, payload)
            req = payload["request"]
            if not ok:
                hdst.requeue_front(req)  # zero-drop fallback: replay
            stall = time.perf_counter() - t_pause
        except (TR.TransportClosed, TR.RpcTimeout) as e:
            # the DESTINATION failed between pause and commit — the
            # rollback-hardening window. The payload in hand is the
            # only copy: the source stays authoritative (requeue +
            # deterministic replay). The staged slots die with the
            # dead/quarantined destination process; a HUNG destination
            # is killed by the quarantine before replay, so a commit
            # that half-landed can never decode — no duplication.
            if hsrc.alive():
                hsrc.requeue_front(payload["request"])
            self._fail_instance(dst, hung=isinstance(e, TR.RpcTimeout),
                                t_obs=t_obs)
            return None
        shipped = payload["kv"]["nbytes"]   # delta, or the full re-ship
        delta_bytes = shipped if staged is not None else 0
        nbytes = ticket["snap_bytes"] + shipped
        rec = MigrationRecord(
            rid=req.rid, src=src, dst=dst,
            n_blocks=ticket["snap_blocks"],
            bytes_moved=nbytes, seconds=time.perf_counter() - ticket["t0"],
            est_seconds=MIG.estimate_cost(nbytes, self.link_bandwidth),
            resumed=ok, mode="overlapped", stall_s=stall,
            delta_blocks=(len(payload["kv"]["cols"])
                          if staged is not None else 0),
            delta_bytes=delta_bytes)
        self._home[req.rid] = dst
        self.migrations.append(rec)
        self._record_migration(rec, ticket["t_hop0"])
        return rec

    def migrate_requests_overlapped(self, src: int, dst: int,
                                    max_requests: Optional[int] = None,
                                    overlap_steps: int = 1
                                    ) -> List[MigrationRecord]:
        """Two-phase migration of the source's active requests: begin
        (snapshot + pipelined staging) for every victim, keep the WORLD
        decoding for ``overlap_steps`` engine steps — the source
        included: that is the overlap, and what the phase-2 dirty-set
        delta exists for — then finish (pause-delta-commit) each. The
        victim streams lose at most the one step in which their delta is
        copied."""
        hsrc = self.instances[src]
        slots = sorted(hsrc.active_rids().keys())
        if max_requests is not None:
            slots = slots[:max_requests]
        tickets = [self.begin_migration(src, dst, slot) for slot in slots]
        for _ in range(overlap_steps):
            # the overlap steps ride the same batched poll as the main
            # loop — the source keeps decoding while the destination's
            # staging import is still in flight on its connection
            done = self._step_all()
            self.finished.extend(done)
            self._orphans.extend(done)      # surfaced by the next step()
        out = []
        for t in tickets:
            rec = self.finish_migration(t)
            if rec is not None:
                out.append(rec)
        return out

    def drain_instance(self, idx: int) -> List[MigrationRecord]:
        """Scale-down consolidation: move EVERYTHING (queued requests +
        active KV blocks, the latter overlapped) off instance ``idx``
        onto the least-loaded other instance, leaving ``idx`` empty and
        removable. The queue hands off FIRST so the overlap steps can't
        re-admit at the source (submit_time is preserved: straight
        handoff, no re-submit)."""
        others = [i for i in self._alive() if i != idx]
        assert others, "cannot drain a single-instance deployment"
        dst = min(others, key=lambda i: (self.instances[i].active_count(),
                                         self.instances[i].queue_len()))
        for req in self.instances[idx].drain_queue():
            self._home[req.rid] = dst
            self.instances[dst].push_queue(req)
        return self.migrate_requests_overlapped(idx, dst)

    # ------------------------------------------------------ crash recovery
    def handle_instance_failure(self, idx: int, reason: str = "dead",
                                t_obs: Optional[float] = None,
                                ) -> List[Request]:
        """A remote instance failed (transport EOF, or quarantined
        hung): re-queue replayable clones of every stream it held —
        queued AND mid-decode — on the surviving instances.
        Counter-based sampling keys make the replays token-identical to
        the lost continuations, so the failure costs recompute, never
        output: the zero-drop invariant survives worker loss.
        Idempotent: one death can surface from several in-flight
        operations (a step, several migration tickets); only the FIRST
        observation replays — a duplicate replay would decode the same
        streams twice. Schedules a supervised respawn when a policy is
        armed and the instance is respawnable. Returns the replayed
        requests."""
        if idx in self._recovered:
            return []
        self._recovered.add(idx)
        self._grace.discard(idx)
        now = time.monotonic()
        # wall from when this peer's failure became OBSERVABLE (the
        # failing call's issue time, or the control fan-out for a step
        # classification) — the "hung peer detected within 2x deadline"
        # evidence
        ref = t_obs if t_obs is not None else self._fanout_t
        detect = max(0.0, now - ref) if ref else 0.0
        self.faults.detect_latencies.append(detect)
        h = self.instances[idx]
        replay = h.inflight_requests()
        try:
            h.close()
        except TR.TransportError:
            pass
        for req in replay:
            # a replay re-runs the request from scratch: rebuild the
            # construction-time spec (SLO class and deadline ride along)
            # and let the survivor's engine mint a fresh Request
            spec = RequestSpec.from_request(req)
            placed = False
            while not placed:
                survivors = self._alive()
                assert survivors, \
                    "every instance died: nothing to recover onto"
                j = self._route(survivors, spec=spec)
                # re-attach the live trace: the replayed continuation's
                # spans belong to the SAME tree as the lost ones
                trace = (self.tracer.ctx(req.rid)
                         if self.tracer else None)
                t_sub = time.monotonic()
                try:
                    if trace is None:
                        self.instances[j].submit(spec)
                    else:
                        self.instances[j].submit(spec, trace=trace)
                except (TR.TransportClosed, TR.RpcTimeout) as e:
                    # the chosen survivor failed DURING recovery. Its
                    # mirror already holds the clone (mirror-first
                    # submit), so failing it replays this stream — and
                    # everything else it held — onto the next survivor.
                    self._fail_instance(
                        j, hung=isinstance(e, TR.RpcTimeout),
                        t_obs=t_sub)
                    placed = True
                    continue
                self._home[req.rid] = j
                placed = True
        self.recoveries.append({"instance": idx, "reason": reason,
                                "detect_s": detect,
                                "rids": sorted(r.rid for r in replay)})
        self.flightrec.record("crash_recovery", instance=idx,
                              reason=reason, detect_s=detect,
                              replayed=len(replay),
                              rids=sorted(r.rid for r in replay))
        # the event that makes the recorder worth having: persist the
        # decision history that LED here before anything else goes wrong
        self.flightrec.auto_dump(f"crash_recovery:instance{idx}:{reason}")
        self._schedule_respawn(idx, now)
        return replay

    # -------------------------------------------------- supervised respawn
    def _schedule_respawn(self, idx: int, now: float):
        """Arm the supervisor for a failed instance: record the flap,
        then set the next bring-up attempt at a capped exponential
        backoff. No-op without a policy, for non-respawnable handles
        (attached servers belong to another host), and for evicted
        instances."""
        pol = self.respawn_policy
        h = self.instances[idx]
        if (pol is None or not getattr(h, "respawnable", False)
                or idx in self._evicted or idx in self._retired):
            return
        st = self._respawn.setdefault(
            idx, {"failures": deque(), "attempts": 0, "due": None,
                  "t_fail": now})
        st["t_fail"] = now
        self._record_flap(idx, st, now)
        if idx in self._evicted:
            return
        delay = min(pol.backoff_base * (2 ** st["attempts"]),
                    pol.backoff_cap)
        st["due"] = now + delay

    def _record_flap(self, idx: int, st: dict, now: float):
        """Flap-detector circuit breaker: ``max_failures`` failures of
        the same instance inside ``window_s`` evict it permanently."""
        pol = self.respawn_policy
        fails = st["failures"]
        fails.append(now)
        while fails and now - fails[0] > pol.window_s:
            fails.popleft()
        if len(fails) >= pol.max_failures:
            self._evicted.add(idx)
            self.faults.evictions += 1
            st["due"] = None
            self.respawn_log.append({
                "instance": idx, "event": "evicted",
                "failures_in_window": len(fails)})
            self.flightrec.record("evicted", instance=idx,
                                  failures_in_window=len(fails))

    def _tick_respawns(self):
        """Run due respawns (called at the top of every ``step()`` —
        the supervisor never blocks the serving loop waiting out a
        backoff). A successful bring-up swaps the fresh handle in
        place: same index, same Device in the controller's cluster
        view, empty pool/queue — the controller re-admits it the same
        way it admits any vacant instance. A failed bring-up counts as
        another flap and re-arms with doubled backoff."""
        if not self._respawn:
            return
        pol = self.respawn_policy
        for idx, st in self._respawn.items():
            if (st["due"] is None or idx in self._evicted
                    or time.monotonic() < st["due"]):
                continue
            st["due"] = None
            st["attempts"] += 1
            old = self.instances[idx]
            try:
                fresh = old.respawn(start_timeout=pol.start_timeout)
            except Exception:  # noqa: BLE001 — ANY bring-up failure flaps
                now = time.monotonic()
                self.flightrec.record("respawn_failed", instance=idx,
                                      attempt=st["attempts"])
                self._record_flap(idx, st, now)
                if idx not in self._evicted:
                    st["due"] = now + min(
                        pol.backoff_base * (2 ** st["attempts"]),
                        pol.backoff_cap)
                continue
            if self.rpc_deadline is not None:
                # cold-start grace (see __init__): arm the deadline only
                # after the replica's first completed ACTIVE step
                fresh.set_rpc_deadline(None)
                self._grace.add(idx)
            self.instances[idx] = fresh
            self.telemetry[idx] = fresh.telemetry
            self._preempt_seen[idx] = 0
            self._recovered.discard(idx)   # re-admitted: may fail anew
            self.faults.respawns += 1
            st["attempts"] = 0
            self.respawn_log.append({
                "instance": idx, "event": "respawned",
                "label": getattr(fresh, "peer_label", None),
                "downtime_s": time.monotonic() - st["t_fail"]})
            self.flightrec.record(
                "respawned", instance=idx,
                downtime_s=time.monotonic() - st["t_fail"])

    # -------------------------------------------------------------- summary
    def stats(self) -> Dict:
        ps = [self.instances[i].prefix_stats() for i in self._alive()]
        pq = sum(p["queries"] for p in ps)
        ph = sum(p["hits"] for p in ps)
        ov = [m for m in self.migrations if m.mode == "overlapped"]
        tel = [self.telemetry[i] for i in self._alive()]
        buds = [t.budget_utilization() for t in tel if t.budget]
        return {
            "budget_utilization": (sum(buds) / len(buds)
                                   if buds else 0.0),
            "ttft_p50": max((t.ttft_quantile(0.5) for t in tel),
                            default=0.0),
            "ttft_p95": max((t.ttft_quantile(0.95) for t in tel),
                            default=0.0),
            "queue_delay_p95": max((t.queue_delay_quantile(0.95)
                                    for t in tel), default=0.0),
            "finished": len(self.finished),
            "dropped": self.dropped,
            "migrations": len(self.migrations),
            "migrated_bytes": sum(m.bytes_moved for m in self.migrations),
            "overlapped_migrations": len(ov),
            "mean_stall_s": (sum(m.stall_s for m in ov) / len(ov)
                             if ov else 0.0),
            "preemptions": sum(self._preempt_seen),
            "recoveries": len(self.recoveries),
            "prefix_hit_rate": ph / pq if pq else 0.0,
            "blocks_saved_now": sum(p["blocks_saved_now"] for p in ps),
            "dedup_imports": sum(p.get("dedup_imports", 0) for p in ps),
            "controller_log": list(self.controller.log),
            "plan_p": list(self.plan.p),
            "control_plane": self.control_plane_stats(),
            "faults": dict(self.faults.as_dict(),
                           injected=FLT.injected_total()),
            "respawn_log": list(self.respawn_log),
            "pod": {"size": self.pod_size(),
                    "retired": sorted(self._retired),
                    "grown": sorted(self._grown_at),
                    "log": list(self.pod_log)},
        }

    def control_plane_stats(self) -> Dict:
        """Batched-poll accounting: with any remote instance, every tick
        issues exactly ONE multiplexed drain (``rpc_polls_per_tick`` ==
        1.0) regardless of how many step RPCs fanned out under it."""
        ticks = self.rpc_stats["ticks"]
        return {
            "ticks": ticks,
            "rpc_polls_per_tick": (self.rpc_stats["polls"] / ticks
                                   if ticks else 0.0),
            "step_rpcs_per_tick": (self.rpc_stats["step_rpcs"] / ticks
                                   if ticks else 0.0),
        }
