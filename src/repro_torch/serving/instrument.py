"""Instrumentation for the serving hot loop: host-sync accounting and the
live telemetry of the module-scaling loop.

Counterpart of ``repro.serving.instrument``. Its ``count_host_syncs``
patches ``jax.device_get``; here every device↔host transfer of the
serving path goes through one function of this module, which every
active ``count_host_syncs`` context counts:

* ``fetch`` — a device→host copy, a host sync: the engine's one per
  step (the sampled ids) and a migration export's one per pool array;
* ``upload`` — a host→device copy through pinned memory, non-blocking,
  so no sync: a migration import's block data and indices;
* ``synchronize`` — wait for the card (a migration's wall time is read
  after it);
* ``graph_capture`` — the one host sync of a CUDA-graph capture
  (``torch.cuda.graph`` synchronizes on entry; serving/graphs.py);
* ``collective`` — one collective of a replicated step
  (``core/replication.py``, which counts them by kind on its group):
  where it stages through the host (gloo on CUDA tensors) it is a host
  sync.

On the card, these relax ``torch.cuda.set_sync_debug_mode`` around
themselves, so a run under ``"error"`` mode fails on any other sync.

``GraphCounter`` counts one engine's graph captures and replays, by the
kind of step (``"decode"``, ``"chunk"``, ``"sample"``), beside the sync
counter: a steady decode step replays its graph and makes one host sync,
the fetch; the first step of each static key captures instead. A
replicated decode step never enters a graph and counts as ``eager``.

``FaultCounters``, ``IngressCounters``, ``EngineTelemetry`` and
``timed_step`` are copies of the reference's: the orchestrator folds
them into ``core.monitor.MetricsSnapshot``, the ingress serves its
counters at ``GET /stats``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import to_device


@dataclasses.dataclass(eq=False)   # contexts leave by identity
class SyncCounter:
    n: int = 0          # host syncs: fetches, synchronizes, staged
                        # collectives, graph captures
    uploads: int = 0    # host→device copies (not syncs)


@dataclasses.dataclass
class GraphCounter:
    """One engine's CUDA-graph captures and replays, and the steps run
    eagerly because their collectives cannot be captured, by step kind."""
    captures: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    replays: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    eager: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)


@dataclasses.dataclass
class FaultCounters:
    """Plane-wide failure-domain counters, owned by the orchestrator
    (one per plane, not per engine — a quarantine is a fleet event).
    Feeds the ``rpc_timeouts`` / ``quarantines`` / ``respawns`` gauges
    of ``core.monitor.MetricsSnapshot`` and the recovery-latency
    percentiles of benchmarks/chaos_bench.py."""
    rpc_timeouts: int = 0     # step/control calls that missed a deadline
    quarantines: int = 0      # hung peers severed (socket open, no reply)
    respawns: int = 0         # supervised restarts that re-admitted
    evictions: int = 0        # flap-detector permanent removals
    # wall seconds from control fan-out to failure classification, one
    # entry per recovery — the "detected within 2x deadline" evidence.
    # Bounded: a week-long chaos soak records one float per recovery
    # forever, and the quantiles only need the recent window anyway.
    detect_latencies: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=512))

    def detect_quantile(self, q: float) -> float:
        if not self.detect_latencies:
            return 0.0
        return float(np.quantile(np.asarray(self.detect_latencies), q))

    def as_dict(self) -> dict:
        return {"rpc_timeouts": self.rpc_timeouts,
                "quarantines": self.quarantines,
                "respawns": self.respawns,
                "evictions": self.evictions,
                "detect_p50_s": self.detect_quantile(0.50),
                "detect_p95_s": self.detect_quantile(0.95)}


@dataclasses.dataclass
class IngressCounters:
    """Front-door counters, owned by ``serving.ingress.Ingress`` (one
    per server). Surfaced by ``GET /stats`` next to the orchestrator's
    MetricsSnapshot (routed_prefix vs routed_vacancy is the
    affinity-hit ledger; rejected_429 the backpressure one)."""
    requests: int = 0         # completions requests accepted
    streamed: int = 0         # of those, served with stream=true
    rejected_429: int = 0     # admissions shed by backpressure
    bad_requests: int = 0     # malformed -> HTTP 400
    tokens_out: int = 0       # tokens flushed to clients
    routed_prefix: int = 0    # admissions routed by chain affinity
    routed_vacancy: int = 0   # admissions routed by vacancy fallback
    aborted_streams: int = 0  # streams cut by shutdown / client hangup

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class EngineTelemetry:
    """Rolling-window per-engine counters feeding core/monitor."""

    def __init__(self, window: int = 64):
        self.step_seconds: Deque[float] = deque(maxlen=window)
        self.step_tokens: Deque[int] = deque(maxlen=window)
        self.finished_latencies: Deque[float] = deque(maxlen=window)
        # continuous-batching signals (token-budget scheduler): tokens
        # PACKED per step (decode + granted prefill chunk tokens) against
        # the engine's fixed budget, time-to-first-token and queue delay
        # per finished request — all on the ENGINE clock, like latencies
        self.packed_tokens: Deque[int] = deque(maxlen=window)
        self.budget = 0
        self.ttfts: Deque[float] = deque(maxlen=window)
        self.queue_delays: Deque[float] = deque(maxlen=window)
        # per-SLO-class rolling windows (class -> deque), populated
        # lazily so a plane that never sends slo_class pays nothing.
        # TTFT as above; ITL is the per-finished-request mean
        # inter-token gap ON THE ENGINE CLOCK — ~1.0 for a stream that
        # decoded every step, >1 when preemption/budget pressure
        # stalled it, which is exactly the per-class fairness signal
        self.class_ttfts: dict = {}
        self.class_itls: dict = {}
        self.total_tokens = 0
        self.total_finished = 0
        self.preemptions_seen = 0
        # prefix-sharing gauges (latest engine counters, not windows):
        # cumulative cache lookups/hits plus the INSTANTANEOUS number of
        # physical blocks sharing is saving — the quantity that inflates
        # the controller's pool-vacancy signal
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.blocks_saved = 0

    def record_step(self, wall_s: float, n_tokens: int,
                    packed: Optional[int] = None,
                    budget: Optional[int] = None):
        self.step_seconds.append(wall_s)
        self.step_tokens.append(n_tokens)
        self.total_tokens += n_tokens
        if packed is not None:
            self.packed_tokens.append(packed)
        if budget:
            self.budget = budget

    def record_finished(self, requests: Iterable):
        w = self.step_seconds.maxlen
        for r in requests:
            self.finished_latencies.append(r.finish_time - r.submit_time)
            self.total_finished += 1
            cls = getattr(r, "slo_class", "standard")
            if r.first_token_time is not None:
                ttft = r.first_token_time - r.submit_time
                self.ttfts.append(ttft)
                self.class_ttfts.setdefault(
                    cls, deque(maxlen=w)).append(ttft)
                n = len(getattr(r, "generated", ()))
                if n > 1:
                    itl = (r.finish_time - r.first_token_time) / (n - 1)
                    self.class_itls.setdefault(
                        cls, deque(maxlen=w)).append(itl)
            start = getattr(r, "prefill_start_time", None)
            if start is not None:
                self.queue_delays.append(start - r.submit_time)

    def record_preemptions(self, n: int):
        self.preemptions_seen += n

    def record_prefix(self, queries: int, hits: int, blocks_saved_now: int):
        """Overwrite the sharing gauges with the engine's live counters
        (queries/hits are cumulative on the engine side; blocks saved is
        an instantaneous point read)."""
        self.prefix_queries = queries
        self.prefix_hits = hits
        self.blocks_saved = blocks_saved_now

    def prefix_hit_rate(self) -> float:
        """Fraction of looked-up full prompt blocks served by aliasing an
        already-resident block instead of re-prefilling it."""
        return (self.prefix_hits / self.prefix_queries
                if self.prefix_queries else 0.0)

    def budget_utilization(self) -> float:
        """Mean fraction of the per-step token budget actually packed
        (decode tokens + granted prefill chunks) over the window — the
        continuous-batching load gauge: ~1.0 means the step loop is
        saturated, low values mean the budget could shrink (latency) or
        traffic is light. 0.0 when the engine runs the phase scheduler
        (no budget to pack)."""
        if not self.budget or not self.packed_tokens:
            return 0.0
        return (sum(self.packed_tokens)
                / (len(self.packed_tokens) * self.budget))

    def ttft_quantile(self, q: float) -> float:
        """Engine-clock time-to-first-token quantile over the window —
        the signal chunked prefill exists to bound: admission no longer
        waits for a whole free slot + full-prompt prefill."""
        if not self.ttfts:
            return 0.0
        return float(np.quantile(np.asarray(self.ttfts), q))

    def queue_delay_quantile(self, q: float) -> float:
        """Engine-clock submit -> first-chunk-admitted delay quantile."""
        if not self.queue_delays:
            return 0.0
        return float(np.quantile(np.asarray(self.queue_delays), q))

    def class_ttft_quantile(self, cls: str, q: float) -> float:
        """Per-SLO-class TTFT quantile (0.0 when the class has no
        finished requests in the window yet)."""
        d = self.class_ttfts.get(cls)
        if not d:
            return 0.0
        return float(np.quantile(np.asarray(d), q))

    def class_itl_quantile(self, cls: str, q: float) -> float:
        """Per-SLO-class mean-inter-token-latency quantile (engine
        clock; 1.0 = never stalled)."""
        d = self.class_itls.get(cls)
        if not d:
            return 0.0
        return float(np.quantile(np.asarray(d), q))

    def tokens_per_s(self) -> float:
        wall = sum(self.step_seconds)
        return sum(self.step_tokens) / wall if wall > 0 else 0.0

    def mean_step_s(self) -> float:
        return (sum(self.step_seconds) / len(self.step_seconds)
                if self.step_seconds else 0.0)

    def latency_quantile(self, q: float) -> float:
        if not self.finished_latencies:
            return 0.0
        return float(np.quantile(np.asarray(self.finished_latencies), q))

    def slo_violation_rate(self, slo_latency: float) -> float:
        """Fraction of recently finished requests whose ENGINE-CLOCK
        latency (finish - submit) blew the SLO — the §5 scale-down
        trigger, measured on real requests rather than a trace."""
        if not self.finished_latencies:
            return 0.0
        lats = np.asarray(self.finished_latencies)
        return float((lats > slo_latency).mean())

    # ------------------------------------------------ wire serialization
    # A remote engine server (serving/remote_engine.py) measures its own
    # steps — wall seconds WITHOUT the RPC round trip — and ships this
    # state back piggybacked on every step reply; the orchestrator-side
    # mirror is refreshed with load_state, so core/monitor sees the same
    # schema whether the engine is a local object or another process.

    def to_state(self) -> dict:
        return {"window": self.step_seconds.maxlen,
                "step_seconds": list(self.step_seconds),
                "step_tokens": list(self.step_tokens),
                "finished_latencies": list(self.finished_latencies),
                "total_tokens": self.total_tokens,
                "total_finished": self.total_finished,
                "preemptions_seen": self.preemptions_seen,
                "prefix_queries": self.prefix_queries,
                "prefix_hits": self.prefix_hits,
                "blocks_saved": self.blocks_saved,
                "packed_tokens": list(self.packed_tokens),
                "budget": self.budget,
                "ttfts": list(self.ttfts),
                "queue_delays": list(self.queue_delays),
                "class_ttfts": {c: list(d)
                                for c, d in self.class_ttfts.items()},
                "class_itls": {c: list(d)
                               for c, d in self.class_itls.items()}}

    def load_state(self, state: dict):
        """Overwrite this telemetry with a serialized snapshot (in place:
        the orchestrator holds a reference to this object)."""
        w = state.get("window") or self.step_seconds.maxlen
        self.step_seconds = deque(state["step_seconds"], maxlen=w)
        self.step_tokens = deque(state["step_tokens"], maxlen=w)
        self.finished_latencies = deque(state["finished_latencies"],
                                        maxlen=w)
        self.total_tokens = state["total_tokens"]
        self.total_finished = state["total_finished"]
        self.preemptions_seen = state["preemptions_seen"]
        self.prefix_queries = state["prefix_queries"]
        self.prefix_hits = state["prefix_hits"]
        self.blocks_saved = state["blocks_saved"]
        # .get defaults: replies from an engine server predating the
        # continuous-batching gauges still load
        self.packed_tokens = deque(state.get("packed_tokens", []),
                                   maxlen=w)
        self.budget = state.get("budget", 0)
        self.ttfts = deque(state.get("ttfts", []), maxlen=w)
        self.queue_delays = deque(state.get("queue_delays", []),
                                  maxlen=w)
        self.class_ttfts = {c: deque(v, maxlen=w) for c, v
                            in state.get("class_ttfts", {}).items()}
        self.class_itls = {c: deque(v, maxlen=w) for c, v
                           in state.get("class_itls", {}).items()}


def timed_step(engine, telemetry: EngineTelemetry):
    """Run one engine step and record it into ``telemetry`` — THE step
    accounting definition, shared by the local handle
    (serving/instance.LocalInstance) and the remote engine server
    (serving/remote_engine.EngineServer) so the two planes' metrics can
    never silently diverge. Returns the finished requests."""
    t0 = time.perf_counter()
    done = engine.step() or []
    telemetry.record_step(time.perf_counter() - t0,
                          len(engine.active) + len(done),
                          packed=getattr(engine, "last_step_packed", None),
                          budget=getattr(engine, "token_budget", 0))
    telemetry.record_finished(done)
    return done


_lock = threading.Lock()
_active: list = []


def _count(field: str):
    with _lock:
        for c in _active:
            setattr(c, field, getattr(c, field) + 1)


def fetch(t: torch.Tensor) -> np.ndarray:
    """Copy ``t`` to the host: THE device→host sync of an engine step.
    The result is a finished host copy, independent of ``t``."""
    _count("n")
    if not t.is_cuda:
        return t.numpy().copy()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return t.cpu().numpy()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def upload(a, device) -> torch.Tensor:
    """A host array on ``device`` without a host sync
    (``transformer.to_device``: pinned and non-blocking on CUDA)."""
    _count("uploads")
    return to_device(a, device)


def synchronize(device):
    """Wait until ``device`` has finished its queued work (no-op off
    CUDA). Counted as a host sync."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    _count("n")
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        torch.cuda.synchronize(device)
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def collective(op, staged: bool):
    """Run ``op()``, one collective that waits for its result. Where it
    stages through the host (``staged``: gloo copies CUDA tensors to the
    host and back) it is counted as a host sync, with sync-debug mode
    relaxed around it."""
    if not staged:
        return op()
    _count("n")
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return op()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def graph_capture():
    """Around a CUDA-graph capture: counted as one host sync (the
    capture synchronizes the device on entry), with sync-debug mode
    relaxed inside."""
    _count("n")
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def bits_checksum(t: torch.Tensor, chunk: int = 1 << 25) -> List[int]:
    """Two wrapping int64 sums of ``t``'s bits, plain and
    position-weighted, computed on its device and fetched (one host
    sync): equal bits give equal sums."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = t.reshape(-1).view(ints[t.element_size()])
    sums = torch.zeros(2, dtype=torch.int64, device=t.device)
    for i in range(0, flat.numel(), chunk):
        x = flat[i:i + chunk].long()
        w = torch.arange(i, i + x.numel(), device=t.device) % 65521 + 1
        sums[0] += x.sum()
        sums[1] += (x * w).sum()
    return [int(v) for v in fetch(sums)]


@contextlib.contextmanager
def count_host_syncs():
    """Context manager yielding a SyncCounter that counts every ``fetch``
    in the process while the block is active. Re-entrant and
    thread-safe: nested or concurrent contexts each get an exact count."""
    counter = SyncCounter()
    with _lock:
        _active.append(counter)
    try:
        yield counter
    finally:
        with _lock:
            _active.remove(counter)
