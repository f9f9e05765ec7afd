"""InstanceHandle — the orchestrator's transport-agnostic view of one
serving instance.

The §5 control loop (serving/orchestrator.py) composes N model replicas.
Before the distributed plane, those were N in-process ``Engine`` objects
and the orchestrator reached straight into their attributes; now an
instance may equally be a real paged Engine living in ANOTHER PROCESS
behind the RPC wire protocol (serving/transport.py +
serving/remote_engine.py). This module defines the one interface both
sides present, so the orchestrator contains no transport knowledge at
all:

* **serving ops** — ``submit`` / ``step`` / ``apply_plan`` and the queue
  surgery the zero-drop paths need (``requeue_front``, ``push_queue``,
  ``drain_queue``);
* **telemetry** — every handle owns an ``EngineTelemetry`` (local:
  recorded around the direct call; remote: a mirror refreshed from the
  server's serialized snapshot piggybacked on each step reply) plus the
  point gauges ``free_blocks`` / ``blocks_in_use`` / ``queue_len`` /
  ``active_rids`` / ``clock`` / ``preempt_count`` / ``prefix_stats``
  the orchestrator folds into ``core.monitor.MetricsSnapshot``;
* **migration** — the stop-the-world pair (``pause_request`` /
  ``resume_request``) and the two-phase overlapped quartet
  (``snapshot_request`` → ``prepare_resume`` → ``pause_request(...,
  since_epoch)`` → ``commit_resume`` | ``abort_resume``).
  ``prepare_resume_async`` returns a waitable so the orchestrator can
  keep the bulk phase-1 import in flight on the destination while it
  keeps STEPPING the source — the overlap that bounds the victim
  stream's stall to the phase-2 delta;
* **liveness** — ``alive`` / ``close``; a dead remote raises
  ``transport.TransportClosed`` from any op, which the orchestrator's
  crash recovery turns into re-queue + deterministic replay of the
  handle's ``inflight_requests`` mirror.

Counterpart of ``repro.serving.instance`` for the port: ``pristine``,
``Completed``, ``InstanceHandle`` and ``LocalInstance``; the remote
handle is ``remote_engine.EngineProxy``. Where the reference waits for
its pool arrays after an import, ``LocalInstance`` waits for the
engine's device (``instrument.synchronize``: a no-op on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.serving import instrument as INS
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.instrument import EngineTelemetry
from repro_torch.serving.request import RequestSpec


def pristine(req: Request) -> Request:
    """A replayable clone: same identity/sampling state (rid, prompt,
    seed, counters restart at 0), all per-run mutable state reset.
    Counter-based sampling keys make re-running it from scratch
    reproduce the original stream token-for-token — the zero-drop
    recovery primitive."""
    return dataclasses.replace(
        req, generated=[], slot=None, submit_time=0.0,
        first_token_time=None, finish_time=None, preemptions=0,
        prefill_pos=0, prefill_start_time=None)


class Completed:
    """Already-resolved stand-in for a transport ``Pending`` (local
    handles execute synchronously)."""

    def __init__(self, value):
        self._value = value

    def wait(self):
        return self._value


class InstanceHandle:
    """Abstract control surface of one serving instance (see module
    docstring). Concrete: ``LocalInstance`` below,
    ``remote_engine.EngineProxy`` for the multi-process plane."""

    telemetry: EngineTelemetry

    # ------------------------------------------------------ serving ops
    def submit(self, spec: RequestSpec, trace: Optional[dict] = None):
        """Enqueue one request, described by its construction-time
        ``RequestSpec`` (serving/request.py — the engine mints the
        mutable ``Request``). ``trace`` is an optional observe.Tracer
        propagation context ({"trace_id", "rid"}) that makes the
        instance record engine-side spans for this request."""
        raise NotImplementedError

    def set_token_budget(self, budget: int) -> int:
        """Retarget the engine's per-step token budget (the ingress
        budget governor's knob). Returns the budget now in force; 0
        means the instance has no budgeted scheduler to govern."""
        return 0

    def step(self) -> List[Request]:
        raise NotImplementedError

    def step_async(self):
        """Fan-out half of the orchestrator's batched control-plane
        poll: return a waitable (``transport.Pending`` for a remote
        instance, ``Completed`` here) whose resolution is the opaque
        step reply ``finish_step`` consumes. The default executes the
        step synchronously — a local engine shares the orchestrator's
        process, so there is nothing to overlap."""
        return Completed(self.step())

    def finish_step(self, reply) -> List[Request]:
        """Consume one resolved ``step_async`` reply, returning the
        finished requests. Local steps already ARE the finished list."""
        return reply

    def mark_dead(self):
        """Record a transport death observed outside a direct call
        (e.g. a ``closed`` entry from the batched poll). Local
        instances cannot outlive the orchestrator: no-op."""

    def apply_plan(self, p: List[int]):
        raise NotImplementedError

    def requeue_front(self, req: Request):
        raise NotImplementedError

    def push_queue(self, req: Request):
        raise NotImplementedError

    def drain_queue(self) -> List[Request]:
        raise NotImplementedError

    # -------------------------------------------------------- telemetry
    def queue_len(self) -> int:
        raise NotImplementedError

    def active_rids(self) -> Dict[int, int]:
        """slot -> rid of every request HOLDING a slot — decoding or
        mid-prefill (chunked prefill makes partially-prefilled state
        first-class: such slots hold blocks and are migratable)."""
        raise NotImplementedError

    def active_count(self) -> int:
        return len(self.active_rids())

    def free_blocks(self) -> int:
        raise NotImplementedError

    def blocks_in_use(self) -> int:
        raise NotImplementedError

    @property
    def n_blocks(self) -> int:
        raise NotImplementedError

    @property
    def max_batch(self) -> int:
        raise NotImplementedError

    def pool_bytes(self) -> int:
        raise NotImplementedError

    def clock(self) -> float:
        raise NotImplementedError

    def preempt_count(self) -> int:
        raise NotImplementedError

    def prefix_stats(self) -> dict:
        raise NotImplementedError

    @property
    def block_size(self) -> int:
        """Pool block granularity (0 = dense/no pool) — what the pod
        router hashes incoming prompts by (serving/router.py)."""
        return 0

    def prefix_keys(self) -> set:
        """Hex content-chain keys resident in this instance's prefix
        cache, as of the last observation — the router's affinity
        signal. May be one step stale for a remote instance (costs a
        routing miss, never correctness)."""
        return set()

    def stream_view(self) -> Dict[int, List[int]]:
        """rid -> tokens generated so far by every slot-holding request,
        as of the last completed step — the ingress streaming feed.
        Full token lists (idempotent under migration/replay), not
        deltas; consumers keep a high-water mark."""
        return {}

    # ---------------------------------------------------------- tracing
    def register_trace(self, ctx: dict):
        """Associate a trace context with its rid on this instance so
        engine-side spans record for it — the explicit path migration /
        replay continuations use (a fresh submit carries the context on
        the frame instead). Default: tracing not wired, no-op."""

    def drain_spans(self) -> List[dict]:
        """Engine-recorded spans closed since the last drain, already
        on the ORCHESTRATOR's clock (remote handles skew-correct before
        buffering). The orchestrator feeds these to the Tracer each
        step."""
        return []

    # -------------------------------------------------------- migration
    def pause_request(self, slot: int,
                      since_epoch: Optional[int] = None) -> dict:
        raise NotImplementedError

    def resume_request(self, payload: dict) -> bool:
        raise NotImplementedError

    def snapshot_request(self, slot: int) -> dict:
        raise NotImplementedError

    def prepare_resume(self, snap: dict) -> Optional[int]:
        return self.prepare_resume_async(snap).wait()

    def prepare_resume_async(self, snap: dict):
        raise NotImplementedError

    def commit_resume(self, slot: int, payload: dict) -> bool:
        raise NotImplementedError

    def abort_resume(self, slot: int):
        raise NotImplementedError

    # --------------------------------------------------------- liveness
    #: can the orchestrator's supervisor restart this instance after it
    #: dies? True only for remote handles whose server process we own
    #: (EngineProxy overrides with a property).
    respawnable: bool = False

    def alive(self) -> bool:
        return True

    def set_rpc_deadline(self, seconds: Optional[float]):
        """Per-call deadline for remote handles; a local call cannot
        hang independently of the orchestrator — no-op."""

    def probe(self, timeout: float = 1.0) -> str:
        """Hung-vs-dead classification after a missed deadline
        (``"alive"`` / ``"hung"`` / ``"dead"``). A local instance is
        exactly as alive as its ``alive()``."""
        return "alive" if self.alive() else "dead"

    def quarantine(self):
        """Permanently remove a hung peer from the plane (close
        transport, kill an owned process). Local instances share our
        process: nothing to sever."""

    def inflight_requests(self) -> List[Request]:
        """Replayable clones of every request this instance currently
        holds (queued or active) — the crash-recovery worklist. Local
        instances die with the orchestrator, so theirs is empty."""
        return []

    def close(self):
        pass


class LocalInstance(InstanceHandle):
    """An Engine in this process behind the handle interface — the
    degenerate transport. Telemetry is recorded around the direct call
    (mirroring what a remote engine server does around its)."""

    def __init__(self, engine: Engine,
                 telemetry: Optional[EngineTelemetry] = None):
        self.engine = engine
        self.telemetry = telemetry or EngineTelemetry()
        self._recorder = None   # lazy observe.EngineSpanRecorder

    # ------------------------------------------------------ serving ops
    def submit(self, spec: RequestSpec, trace: Optional[dict] = None):
        if trace is not None:
            self.register_trace(trace)
        self.engine.submit(spec)

    def set_token_budget(self, budget: int) -> int:
        return self.engine.set_token_budget(budget)

    # ---------------------------------------------------------- tracing
    def register_trace(self, ctx: dict):
        if self._recorder is None:
            from repro_torch.serving import observe as OBS
            self._recorder = OBS.EngineSpanRecorder(origin="local")
            self.engine.span_hook = self._recorder
        self._recorder.register(int(ctx["rid"]), ctx["trace_id"])

    def drain_spans(self) -> List[dict]:
        return self._recorder.drain() if self._recorder else []

    def step(self) -> List[Request]:
        return INS.timed_step(self.engine, self.telemetry)

    def apply_plan(self, p):
        self.engine.apply_plan(p)

    def requeue_front(self, req: Request):
        self.engine.queue.appendleft(req)

    def push_queue(self, req: Request):
        self.engine.queue.append(req)

    def drain_queue(self) -> List[Request]:
        out = []
        while self.engine.queue:
            out.append(self.engine.queue.popleft())
        return out

    # -------------------------------------------------------- telemetry
    def queue_len(self) -> int:
        return len(self.engine.queue)

    def active_rids(self) -> Dict[int, int]:
        return self.engine.slot_rids()

    def free_blocks(self) -> int:
        return self.engine.pstate.free_block_count()

    def blocks_in_use(self) -> int:
        return self.engine.pstate.blocks_in_use()

    @property
    def n_blocks(self) -> int:
        return self.engine.pstate.n_blocks

    @property
    def max_batch(self) -> int:
        return self.engine.max_batch

    def pool_bytes(self) -> int:
        return self.engine.pstate.pool_bytes()

    def clock(self) -> float:
        return self.engine.clock

    def preempt_count(self) -> int:
        return self.engine.preempt_count

    def prefix_stats(self) -> dict:
        return self.engine.prefix_stats()

    @property
    def block_size(self) -> int:
        return self.engine.block_size

    def prefix_keys(self) -> set:
        return self.engine.prefix_keys()

    def stream_view(self) -> Dict[int, List[int]]:
        return self.engine.stream_progress()

    # -------------------------------------------------------- migration
    def pause_request(self, slot: int,
                      since_epoch: Optional[int] = None) -> dict:
        return self.engine.pause_request(slot, since_epoch=since_epoch)

    def resume_request(self, payload: dict) -> bool:
        ok = self.engine.resume_request(payload)
        INS.synchronize(self.engine.device)
        return ok

    def snapshot_request(self, slot: int) -> dict:
        return self.engine.snapshot_request(slot)

    def prepare_resume_async(self, snap: dict) -> Completed:
        return Completed(self.engine.prepare_resume(snap))

    def commit_resume(self, slot: int, payload: dict) -> bool:
        ok = self.engine.commit_resume(slot, payload)
        INS.synchronize(self.engine.device)
        return ok

    def abort_resume(self, slot: int):
        self.engine.abort_resume(slot)
