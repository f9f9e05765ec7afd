"""Serving front door: a dependency-free async HTTP/1.1 ingress over
the orchestrator (DESIGN.md §11).

The plane's first client-facing surface, in the repo's no-framework
transport style: stdlib ``asyncio`` streams and hand-rolled HTTP/1.1 —
request line + headers parsed directly, responses with explicit
``Content-Length`` or ``Transfer-Encoding: chunked`` — the same way
serving/transport.py hand-rolls its RPC frames. Endpoints:

* ``POST /v1/completions`` — the de-facto standard completion API.
  Body: ``{"prompt": [token ids] | "text", "max_tokens", "temperature",
  "top_k", "seed", "stream", "slo_class", "deadline_ms"}``, parsed
  straight into a ``serving.request.RequestSpec`` — the one request
  shape the whole stack speaks. Bad bodies get a TYPED 400 taxonomy:
  unknown top-level keys, an unknown ``slo_class`` and a non-positive
  ``deadline_ms`` each answer with a distinct machine-readable
  ``error`` code (``unknown_fields`` / ``unknown_slo_class`` /
  ``bad_deadline``) so clients can tell a typo from a bad value without
  string-matching free text. With ``stream: true`` the response is
  chunked SSE: one ``data: {"token": t, "index": n}`` event per token,
  flushed AS THE STEP LOOP EMITS IT (not after completion), terminated
  by ``data: [DONE]``. Without, one JSON body after the request
  finishes. String prompts are mapped by a deterministic byte-level
  stand-in tokenizer (``2 + byte % (vocab-2)``) — the repo serves
  randomly initialized reference models, so a real BPE vocabulary would
  add a dependency without adding meaning; token-id prompts are the
  precise interface.
* ``GET /v1/models`` — the served model's identity.
* ``GET /healthz`` — liveness + pod size (the probe surface).
* ``GET /stats`` — the orchestrator's ``MetricsSnapshot`` plus the
  ingress's own ``IngressCounters`` (routing/backpressure ledger).
* ``GET /metrics`` — Prometheus text exposition (serving/observe.py's
  in-repo registry, no client library): request/429/token counters,
  fleet gauges (tok/s, budget utilization, prefix hit rate, pod size),
  per-instance queue depth / vacancy / TTFT / ITL histograms,
  per-SLO-class TTFT/ITL histograms (``slo_class`` label), the
  in-force per-instance token budget, fault counters. Rendered from an
  IMMUTABLE mirror the pump thread rebuilds
  next to ``last_snapshot`` — a scrape never touches the orchestrator.
* ``GET /debug/flightrec`` — the orchestrator's flight-recorder ring
  (controller votes with inputs, migrations with phase timings,
  quarantines/respawns, routing verdicts), newest last.

**Tracing**: every accepted completion opens a trace
(serving/observe.py); its id returns as ``X-Request-Id`` (unary header
/ SSE head). The HTTP thread records accept + route spans; engine-side
spans ride the step replies and the orchestrator closes the tree when
the request finishes, exporting JSONL when ``trace_out`` is set.

**Threading model** — the one invariant everything below serves:
``transport.Rpc`` is NOT thread-safe, so exactly ONE thread (the
**pump**) ever touches the orchestrator's serving ops. The asyncio
event loop runs in its own thread and only (a) parses HTTP, (b) routes
admissions through ``Orchestrator.route`` — which reads nothing but
CACHED gauges (an EngineProxy's ``_info`` mirror), never the wire — and
(c) awaits per-request ``asyncio.Queue``s. The pump drains the
submission queue into ``submit_to``, steps the orchestrator while any
instance has work, and pushes token events into those queues via
``loop.call_soon_threadsafe`` — tokens cross the thread boundary, RPCs
never do. Elasticity rides for free: the pump's ``step()`` runs the
orchestrator's control ticks, so pod grow/shrink happens on the same
thread that owns the instances.

**Budget governor**: the pump also runs the adaptive half of the
SLO loop (DESIGN.md §13). ``BudgetGovernor`` periodically reads each
instance's EXISTING telemetry windows — ``budget_utilization``,
engine-clock TTFT p95 and queue-delay p95 — and retargets that
instance's per-step token budget through
``InstanceHandle.set_token_budget``: grow when the step loop is
saturated AND requests are queueing (more prefill tokens pack per
step), shrink when the budget is mostly idle (a smaller budget
tightens per-step latency). Multiplicative steps with a clamp; every
change lands in the flight recorder as a ``budget_governor`` event.

**Admission backpressure**: the router only considers instances whose
queue — including requests accepted here but not yet pumped
(``_pending``) — is under the orchestrator's ``max_queue``. When none
qualifies the ingress answers ``429`` with ``Retry-After`` instead of
queueing unboundedly; load sheds at the door, not as pool OOM.

**Graceful shutdown**: ``close()`` stops intake (503), sends every open
stream a ``data: {"error": "shutting down"}`` event followed by the
proper zero-length chunk terminator (clients see a well-formed HTTP
tail, not a reset), then stops the pump and joins both threads.

Copy of ``repro.serving.ingress`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.serving import observe as OBS
from repro_torch.serving.engine import Request
from repro_torch.serving.instrument import IngressCounters
from repro_torch.serving.request import RequestSpec, SamplingParams, SpecError


def byte_tokens(text: str, vocab_size: int) -> np.ndarray:
    """Deterministic byte-level stand-in tokenizer (module docstring):
    identical text -> identical token ids -> identical content-chain
    keys, so string-prompt clients still exercise prefix affinity."""
    span = max(vocab_size - 2, 1)
    return np.asarray([2 + b % span for b in text.encode("utf-8")],
                      np.int32)


class _BadRequest(Exception):
    """Malformed HTTP or JSON — answered with 400. ``body``, when set,
    is the exact JSON error body (the typed taxonomy: unknown fields /
    unknown slo_class / bad deadline); None means the responder's
    generic 400 body."""

    def __init__(self, body: Optional[dict] = None):
        super().__init__((body or {}).get("error", "bad request"))
        self.body = body


class BudgetGovernor:
    """The adaptive token-budget loop (module docstring, DESIGN.md §13).

    Ticked from the pump thread — ``set_token_budget`` is a serving op
    (an RPC on remote instances) and may only run there. Control law:

    * **grow** (``x grow``) when the window says the step loop is
      saturated (``budget_utilization >= high_util``) AND requests are
      actually waiting (queue-delay or TTFT p95 at or above
      ``delay_steps`` engine steps) — a bigger budget packs more
      prefill chunk tokens per step, draining the queue;
    * **shrink** (``x shrink``) when the budget mostly rides empty
      (``utilization <= low_util``) — a smaller budget tightens
      per-step wall time, which is ITL for every active stream.

    Multiplicative moves bounded to [min_budget, max_budget]; the
    engine echoes the budget IN FORCE (phase engines echo 0 and are
    skipped via their empty ``packed_tokens`` window)."""

    def __init__(self, orch, *, period_s: float = 0.5, grow: float = 1.5,
                 shrink: float = 0.75, high_util: float = 0.90,
                 low_util: float = 0.35, delay_steps: float = 4.0,
                 min_budget: int = 32, max_budget: int = 8192):
        self.orch = orch
        self.period_s = period_s
        self.grow = grow
        self.shrink = shrink
        self.high_util = high_util
        self.low_util = low_util
        self.delay_steps = delay_steps
        self.min_budget = min_budget
        self.max_budget = max_budget
        self.budgets: Dict[int, int] = {}   # instance -> in-force budget
        self.adjustments = 0                # lifetime changes applied
        self._t_last: Optional[float] = None

    def tick(self, now: float) -> bool:
        """One control decision per alive instance, at most once per
        ``period_s``. Returns True when a tick ran (tests key on it)."""
        if self._t_last is not None and now - self._t_last < self.period_s:
            return False
        self._t_last = now
        o = self.orch
        for i in o._alive():
            tel = o.telemetry[i]
            if not tel.budget or not tel.packed_tokens:
                continue                    # phase engine, or no data yet
            util = tel.budget_utilization()
            cur = self.budgets.get(i, tel.budget)
            delay = max(tel.queue_delay_quantile(0.95),
                        tel.ttft_quantile(0.95))
            if util >= self.high_util and delay >= self.delay_steps:
                new = min(int(cur * self.grow), self.max_budget)
            elif util <= self.low_util:
                new = max(int(cur * self.shrink), self.min_budget)
            else:
                new = cur
            if new == cur:
                continue
            in_force = o.instances[i].set_token_budget(new)
            self.budgets[i] = in_force
            self.adjustments += 1
            o.flightrec.record(
                "budget_governor", instance=i, budget=in_force,
                prev=cur, utilization=round(util, 4),
                queue_delay_p95=round(delay, 3))
        return True


@dataclasses.dataclass
class _Session:
    """One in-flight completion: the bridge between the pump thread
    (producer) and the handler coroutine (consumer)."""
    rid: int
    events: asyncio.Queue          # ("tok", t) | ("done", _) | ("abort", why)
    sent: int = 0                  # pump-side high-water mark into the stream


class Ingress:
    """The HTTP front door over one Orchestrator (module docstring).

    The caller keeps ownership of the orchestrator but MUST stop
    driving it once ``start()`` runs — the pump thread owns every
    serving op until ``close()``.
    """

    def __init__(self, orch, *, host: str = "127.0.0.1", port: int = 0,
                 model_id: Optional[str] = None,
                 trace_out: Optional[str] = None,
                 govern_budget: bool = True):
        self.orch = orch
        # the adaptive token-budget loop (class docstring); govern_budget
        # False pins every instance's budget for identity-sensitive runs
        self.governor = BudgetGovernor(orch) if govern_budget else None
        self.host = host
        self.port = port                   # 0 -> ephemeral; real after start
        self.model_id = model_id or getattr(orch.cfg, "name", None) \
            or getattr(orch.cfg, "family", "model")
        self.counters = IngressCounters()
        self.last_snapshot = None          # refreshed by the pump
        # request tracing: adopt the orchestrator's tracer (a test may
        # have installed one) or own a fresh one; trace_out appends one
        # JSONL line per finished trace
        if orch.tracer is None:
            orch.tracer = OBS.Tracer(out_path=trace_out)
            self._own_tracer = True
        else:
            self._own_tracer = False
        self.tracer = orch.tracer
        self._metrics_mirror = None        # pump-built, swapped atomically
        self._rids = itertools.count(1)
        self._lock = threading.Lock()      # _pending + _sessions + _rids
        self._pending: Dict[int, int] = {}  # instance -> accepted, unpumped
        self._sessions: Dict[int, _Session] = {}
        self._submit_q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._closing = False
        # test hook: while set, the pump neither submits nor steps — the
        # deterministic way to hold queues full for 429 assertions
        self.hold_pump = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._http_thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_error: Optional[BaseException] = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "Ingress":
        self._http_thread = threading.Thread(
            target=self._run_loop, name="ingress-http", daemon=True)
        self._http_thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("ingress failed to bind within 30s")
        self._pump_thread = threading.Thread(
            target=self._pump, name="ingress-pump", daemon=True)
        self._pump_thread.start()
        return self

    def close(self):
        """Graceful shutdown (module docstring): stop intake, abort open
        streams with a well-formed tail, stop the pump, join."""
        if self._loop is None:
            return
        self._closing = True
        try:
            fut = asyncio.run_coroutine_threadsafe(self._shutdown(),
                                                   self._loop)
            fut.result(timeout=10)
        except Exception:
            pass
        self._stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
        if self._own_tracer:
            self.tracer.close()

    async def _shutdown(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for s in sessions:
            self.counters.aborted_streams += 1
            s.events.put_nowait(("abort", "shutting down"))
        await asyncio.sleep(0.05)          # let handlers flush their tails

    def _run_loop(self):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def _bind():
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()

        loop.run_until_complete(_bind())
        try:
            loop.run_forever()
        finally:
            loop.close()

    # --------------------------------------------------------------- pump
    def _has_work(self) -> bool:
        o = self.orch
        return any(o.instances[i].queue_len() or o.instances[i].active_rids()
                   for i in o._alive())

    def _pump(self):
        """The ONLY thread that touches orchestrator serving ops."""
        o = self.orch
        self.last_snapshot = o.snapshot()
        self._metrics_mirror = self._build_mirror()
        t_snap = t_ctl = time.monotonic()
        try:
            while not self._stop.is_set():
                if self.hold_pump.is_set():
                    time.sleep(0.002)
                    continue
                moved = self._drain_submissions()
                if self._has_work():
                    for r in o.step():
                        self._finish(r)
                    self._push_streams()
                    moved = True
                now = time.monotonic()
                if self.governor is not None:
                    self.governor.tick(now)
                if now - t_snap > 0.2 or moved:
                    self.last_snapshot = o.snapshot()
                    # one plain-data mirror per refresh; /metrics (HTTP
                    # thread) renders whichever mirror it observes — it
                    # never reads handles or telemetry deques itself
                    self._metrics_mirror = self._build_mirror()
                    t_snap = now
                if not moved:
                    # step() carries the control ticks under load; while
                    # IDLE the loop must still tick so the idle-driven
                    # pod decision (shrink) can ever fire
                    if (o.pod_cfg is not None
                            and o.worker_factory is not None
                            and now - t_ctl > 0.25):
                        o.control_tick()
                        t_ctl = now
                    time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001 — surface, don't vanish
            self._pump_error = e
            with self._lock:
                sessions = list(self._sessions.values())
                self._sessions.clear()
            for s in sessions:
                self._post(s, ("abort", f"pump failed: {e!r}"))
            raise

    def _drain_submissions(self) -> bool:
        moved = False
        while True:
            try:
                idx, spec = self._submit_q.get_nowait()
            except queue.Empty:
                return moved
            self.orch.submit_to(idx, spec)
            with self._lock:
                n = self._pending.get(idx, 0) - 1
                if n > 0:
                    self._pending[idx] = n
                else:
                    self._pending.pop(idx, None)
            moved = True

    def _post(self, sess: _Session, event):
        """Thread-safe event push into a session's asyncio queue."""
        self._loop.call_soon_threadsafe(sess.events.put_nowait, event)

    def _push_streams(self):
        for rid, toks in self.orch.stream_view().items():
            with self._lock:
                sess = self._sessions.get(rid)
            if sess is None or len(toks) <= sess.sent:
                continue
            for t in toks[sess.sent:]:
                self._post(sess, ("tok", int(t)))
            self.counters.tokens_out += len(toks) - sess.sent
            sess.sent = len(toks)

    def _finish(self, req: Request):
        with self._lock:
            sess = self._sessions.pop(req.rid, None)
        if sess is None:
            return
        toks = list(req.generated)
        for t in toks[sess.sent:]:          # final flush past the mark
            self._post(sess, ("tok", int(t)))
        self.counters.tokens_out += max(0, len(toks) - sess.sent)
        sess.sent = len(toks)
        self._post(sess, ("done", None))

    # ------------------------------------------------------------ protocol
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            try:
                parsed = await self._read_request(reader)
                if parsed is None:          # EOF before a request line
                    return
                method, path, headers, body = parsed
            except _BadRequest as e:
                self.counters.bad_requests += 1
                await self._respond(writer, 400,
                                    e.body or {"error": "bad request"})
                return
            except (asyncio.IncompleteReadError, ValueError,
                    UnicodeDecodeError):
                self.counters.bad_requests += 1
                await self._respond(writer, 400, {"error": "bad request"})
                return
            if self._closing:
                await self._respond(writer, 503,
                                    {"error": "shutting down"})
                return
            if path == "/v1/completions":
                if method != "POST":
                    await self._respond(writer, 405,
                                        {"error": "use POST"})
                    return
                await self._completions(writer, body)
            elif path == "/v1/models" and method == "GET":
                await self._respond(writer, 200, {
                    "object": "list",
                    "data": [{"id": self.model_id, "object": "model",
                              "owned_by": "repro"}]})
            elif path == "/healthz" and method == "GET":
                await self._respond(writer, 200, {
                    "status": "error" if self._pump_error else "ok",
                    "pod_size": self.orch.pod_size()})
            elif path == "/stats" and method == "GET":
                await self._respond(writer, 200, self._stats())
            elif path == "/metrics" and method == "GET":
                await self._respond_text(writer, self._render_metrics())
            elif path == "/debug/flightrec" and method == "GET":
                await self._respond(writer, 200, self.orch.flightrec.dump())
            else:
                await self._respond(writer, 404, {"error": "not found"})
        except (ConnectionError, BrokenPipeError):
            pass                            # client went away mid-reply
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, BrokenPipeError):
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin1").strip().split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise _BadRequest
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            hl = await reader.readline()
            if hl in (b"\r\n", b"\n"):
                break
            if not hl or b":" not in hl:
                raise _BadRequest
            k, v = hl.decode("latin1").split(":", 1)
            headers[k.strip().lower()] = v.strip()
        body = b""
        if "content-length" in headers:
            n = int(headers["content-length"])
            if not 0 <= n <= 8_000_000:
                raise _BadRequest
            body = await reader.readexactly(n)
        return method, path, headers, body

    async def _respond(self, writer, status: int, obj: dict,
                       extra_headers=()):
        reasons = {200: "OK", 400: "Bad Request", 404: "Not Found",
                   405: "Method Not Allowed", 429: "Too Many Requests",
                   503: "Service Unavailable"}
        body = json.dumps(obj).encode()
        head = (f"HTTP/1.1 {status} {reasons.get(status, 'Error')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n")
        for k, v in extra_headers:
            head += f"{k}: {v}\r\n"
        writer.write(head.encode("latin1") + b"\r\n" + body)
        await writer.drain()

    async def _respond_text(self, writer, text: str):
        """Prometheus text exposition (the one non-JSON responder)."""
        body = text.encode("utf-8")
        head = ("HTTP/1.1 200 OK\r\n"
                "Content-Type: text/plain; version=0.0.4; "
                "charset=utf-8\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n")
        writer.write(head.encode("latin1") + body)
        await writer.drain()

    # --------------------------------------------------------- /metrics
    # TTFT is on the ENGINE clock (steps); ITL's stand-in is per-step
    # wall seconds (one decode step emits one token per active stream)
    _TTFT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
    _ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 1.0)
    # per-class ITL is on the ENGINE clock (mean steps between tokens,
    # 1.0 = a stream that decoded every step; see instrument.py)
    _CLASS_ITL_BUCKETS = (1.0, 1.25, 1.5, 2.0, 4.0, 8.0, 16.0)

    def _build_mirror(self) -> dict:
        """Plain-data snapshot of everything /metrics exposes, built on
        the PUMP thread (the only one allowed to read handles and
        telemetry windows). The HTTP thread renders from whichever
        mirror reference it sees — immutable once built."""
        o = self.orch
        snap = self.last_snapshot
        inst = []
        for i, h in enumerate(o.instances):
            if i in o._retired:
                continue
            up = h.alive()
            tel = o.telemetry[i]
            inst.append({
                "idx": i, "up": 1 if up else 0,
                "queue_depth": h.queue_len() if up else 0,
                "block_vacancy": (1.0 - h.blocks_in_use()
                                  / max(h.n_blocks, 1)) if up else 0.0,
                "tokens_per_s": tel.tokens_per_s(),
                "ttfts": list(tel.ttfts),
                "itls": list(tel.step_seconds),
                "token_budget": tel.budget,
                "class_ttfts": {c: list(d)
                                for c, d in tel.class_ttfts.items()},
                "class_itls": {c: list(d)
                               for c, d in tel.class_itls.items()}})
        return {
            "instances": inst,
            "tokens_per_s": snap.tokens_per_s if snap else 0.0,
            "budget_utilization": (snap.budget_utilization
                                   if snap else 0.0),
            "prefix_hit_rate": snap.prefix_hit_rate if snap else 0.0,
            "pod_size": o.pod_size(),
            "faults": {"rpc_timeouts": o.faults.rpc_timeouts,
                       "quarantines": o.faults.quarantines,
                       "respawns": o.faults.respawns,
                       "evictions": o.faults.evictions},
        }

    def _render_metrics(self) -> str:
        """One scrape: counters (plain-int reads, safe cross-thread) +
        the pump's latest immutable mirror, through the in-repo
        registry (serving/observe.py)."""
        reg = OBS.MetricsRegistry()
        c = self.counters
        reg.counter("repro_requests_total",
                    "Completions accepted at the front door.", c.requests)
        reg.counter("repro_http_429_total",
                    "Admissions shed by backpressure.", c.rejected_429)
        reg.counter("repro_bad_requests_total",
                    "Malformed requests answered 400.", c.bad_requests)
        reg.counter("repro_tokens_out_total",
                    "Tokens flushed to clients.", c.tokens_out)
        reg.counter("repro_streams_total",
                    "Completions served as SSE streams.", c.streamed)
        reg.counter("repro_aborted_streams_total",
                    "Streams cut by shutdown or client hangup.",
                    c.aborted_streams)
        reg.counter("repro_routed_total", "Admissions by routing rule.",
                    c.routed_prefix, labels={"reason": "prefix"})
        reg.counter("repro_routed_total", "Admissions by routing rule.",
                    c.routed_vacancy, labels={"reason": "vacancy"})
        m = self._metrics_mirror
        if m is not None:
            reg.gauge("repro_tokens_per_s",
                      "Fleet decode throughput (tokens/s).",
                      m["tokens_per_s"])
            reg.gauge("repro_budget_utilization",
                      "Mean fraction of the per-step token budget "
                      "packed.", m["budget_utilization"])
            reg.gauge("repro_prefix_hit_rate",
                      "Fraction of prompt blocks served from the "
                      "prefix cache.", m["prefix_hit_rate"])
            reg.gauge("repro_pod_size", "Alive, non-retired instances.",
                      m["pod_size"])
            for kind, v in sorted(m["faults"].items()):
                reg.counter("repro_faults_total",
                            "Failure-domain events by kind.", v,
                            labels={"kind": kind})
            for e in m["instances"]:
                lab = {"instance": str(e["idx"])}
                reg.gauge("repro_instance_up",
                          "1 while the instance answers.", e["up"],
                          labels=lab)
                reg.gauge("repro_queue_depth",
                          "Requests queued on the instance.",
                          e["queue_depth"], labels=lab)
                reg.gauge("repro_block_vacancy",
                          "Fraction of the instance's KV pool free.",
                          e["block_vacancy"], labels=lab)
                reg.gauge("repro_instance_tokens_per_s",
                          "Per-instance decode throughput.",
                          e["tokens_per_s"], labels=lab)
                reg.histogram("repro_ttft_steps",
                              "Time to first token, engine-clock steps "
                              "(rolling window).", e["ttfts"],
                              self._TTFT_BUCKETS, labels=lab)
                reg.histogram("repro_itl_seconds",
                              "Inter-token latency: wall seconds per "
                              "engine step (rolling window).", e["itls"],
                              self._ITL_BUCKETS, labels=lab)
                reg.gauge("repro_token_budget",
                          "Per-step token budget in force (0 = phase "
                          "scheduler, nothing to govern).",
                          e["token_budget"], labels=lab)
                for cls in sorted(e["class_ttfts"]):
                    reg.histogram(
                        "repro_class_ttft_steps",
                        "Per-SLO-class time to first token, "
                        "engine-clock steps (rolling window).",
                        e["class_ttfts"][cls], self._TTFT_BUCKETS,
                        labels={"instance": str(e["idx"]),
                                "slo_class": cls})
                for cls in sorted(e["class_itls"]):
                    reg.histogram(
                        "repro_class_itl_steps",
                        "Per-SLO-class mean inter-token gap, "
                        "engine-clock steps (1.0 = never stalled).",
                        e["class_itls"][cls], self._CLASS_ITL_BUCKETS,
                        labels={"instance": str(e["idx"]),
                                "slo_class": cls})
        if self.governor is not None:
            reg.counter("repro_budget_adjustments_total",
                        "Token-budget retargets applied by the "
                        "ingress governor.", self.governor.adjustments)
        reg.counter("repro_traces_exported_total",
                    "Finished traces written to the JSONL sink.",
                    self.tracer.exported)
        reg.counter("repro_trace_spans_dropped_total",
                    "Spans that arrived for unknown/finished traces.",
                    self.tracer.dropped_spans)
        reg.gauge("repro_flightrec_events",
                  "Control-plane events recorded since start.",
                  self.orch.flightrec.dump()["recorded"])
        return reg.render()

    def _stats(self) -> dict:
        snap = self.last_snapshot
        o = self.orch
        return {
            "snapshot": dataclasses.asdict(snap) if snap else None,
            "ingress": self.counters.as_dict(),
            "pod": {"size": o.pod_size(),
                    "retired": sorted(o._retired),
                    "log": list(o.pod_log)},
            "finished": len(o.finished),
            "dropped": o.dropped,
        }

    # --------------------------------------------------------- completions
    # the completion body's contract: exactly these top-level keys
    _BODY_KEYS = frozenset((
        "prompt", "max_tokens", "temperature", "top_k", "seed",
        "eos_id", "stream", "slo_class", "deadline_ms"))

    def _parse_completion(self, body: bytes):
        """Parse one completions body into ``(RequestSpec, stream)``.

        The 400 taxonomy (module docstring): unknown top-level keys
        answer ``unknown_fields`` (naming them), and ``SpecError`` codes
        from spec validation pass through verbatim (``unknown_slo_class``
        / ``bad_deadline``); anything else malformed keeps the generic
        body. The spec is minted with ``rid=0`` — the real stream id is
        stamped on after admission (rids are only spent on accepts)."""
        try:
            obj = json.loads(body.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise _BadRequest from e
        if not isinstance(obj, dict):
            raise _BadRequest
        unknown = sorted(set(obj) - self._BODY_KEYS)
        if unknown:
            raise _BadRequest({
                "error": "unknown_fields",
                "detail": ("unknown top-level keys: "
                           + ", ".join(unknown)),
                "fields": unknown})
        prompt = obj.get("prompt")
        if isinstance(prompt, str) and prompt:
            toks = byte_tokens(prompt, self.orch.cfg.vocab_size)
        elif (isinstance(prompt, list) and prompt
              and all(isinstance(t, int) and 0 <= t for t in prompt)):
            toks = np.asarray(prompt, np.int32)
        else:
            raise _BadRequest
        if len(toks) > 8192:
            raise _BadRequest
        try:
            spec = RequestSpec(
                rid=0, prompt=toks,
                max_tokens=int(obj.get("max_tokens", 16)),
                sampling=SamplingParams(
                    temperature=float(obj.get("temperature", 0.0)),
                    top_k=int(obj.get("top_k", 0)),
                    seed=int(obj.get("seed", 0))),
                eos_id=(None if obj.get("eos_id") is None
                        else int(obj["eos_id"])),
                slo_class=str(obj.get("slo_class", "standard")),
                deadline_ms=(None if obj.get("deadline_ms") is None
                             else float(obj["deadline_ms"])))
            stream = bool(obj.get("stream", False))
        except (TypeError, ValueError) as e:
            raise _BadRequest from e
        if spec.max_tokens > 4096:
            raise _BadRequest
        try:
            spec.validate()
        except SpecError as e:
            if e.code == "malformed":
                raise _BadRequest from e
            raise _BadRequest({"error": e.code,
                               "detail": e.detail}) from e
        return spec, stream

    async def _completions(self, writer, body: bytes):
        t_accept = OBS.server_now()
        try:
            spec, stream = self._parse_completion(body)
        except _BadRequest as e:
            self.counters.bad_requests += 1
            await self._respond(
                writer, 400,
                e.body or {"error": "malformed completion request"})
            return
        # admission: route on CACHED gauges, charging not-yet-pumped
        # accepts so a same-tick burst cannot over-admit. The router
        # sees the full spec — batch-class traffic gets one seat less
        # of queue headroom (router._headroom).
        with self._lock:
            t_route = OBS.server_now()
            decision = self.orch.route(spec=spec,
                                       pending=dict(self._pending))
            if decision is None:
                self.counters.rejected_429 += 1
            else:
                self._pending[decision.idx] = \
                    self._pending.get(decision.idx, 0) + 1
                rid = next(self._rids)
                spec = dataclasses.replace(spec, rid=rid)
                sess = _Session(rid, asyncio.Queue())
                self._sessions[rid] = sess
                self.counters.requests += 1
                if decision.reason == "prefix":
                    self.counters.routed_prefix += 1
                else:
                    self.counters.routed_vacancy += 1
        if decision is None:
            await self._respond(writer, 429,
                                {"error": "all queues full, retry"},
                                extra_headers=[("Retry-After", "1")])
            return
        # open the trace BEFORE the submit queue: the pump attaches its
        # context to the RPC frame, so engine spans record from hook one
        trace_id = self.tracer.begin(
            rid, t0=t_accept, prompt_tokens=int(len(spec.prompt)),
            max_tokens=spec.max_tokens, stream=stream,
            slo_class=spec.slo_class)
        self.tracer.span(rid, "accept", t_accept, t_route)
        self.tracer.span(rid, "route", t_route,
                         attrs={"instance": decision.idx,
                                "reason": decision.reason,
                                "matched_blocks": decision.matched_blocks})
        self._submit_q.put((decision.idx, spec))
        if stream:
            self.counters.streamed += 1
            await self._stream_response(writer, rid, decision, sess,
                                        trace_id)
        else:
            await self._unary_response(writer, rid, decision, sess,
                                       trace_id)

    async def _unary_response(self, writer, rid, decision, sess,
                              trace_id):
        toks = []
        while True:
            kind, val = await sess.events.get()
            if kind == "tok":
                toks.append(val)
            elif kind == "done":
                break
            else:                           # abort
                await self._respond(writer, 503,
                                    {"error": val, "id": rid,
                                     "tokens": toks},
                                    extra_headers=[("X-Request-Id",
                                                    trace_id)])
                return
        await self._respond(writer, 200, {
            "id": rid, "object": "text_completion",
            "model": self.model_id, "tokens": toks,
            "routing": {"instance": decision.idx,
                        "matched_blocks": decision.matched_blocks,
                        "reason": decision.reason},
            "usage": {"completion_tokens": len(toks)}},
            extra_headers=[("X-Request-Id", trace_id)])

    async def _stream_response(self, writer, rid, decision, sess,
                               trace_id):
        head = ("HTTP/1.1 200 OK\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-cache\r\n"
                f"X-Request-Id: {trace_id}\r\n"
                "Transfer-Encoding: chunked\r\n"
                "Connection: close\r\n\r\n")
        writer.write(head.encode("latin1"))
        await writer.drain()

        def chunk(payload: bytes) -> bytes:
            return f"{len(payload):x}\r\n".encode() + payload + b"\r\n"

        # routing verdict first, so clients (and the bench) can audit
        # affinity without scraping /stats
        first = json.dumps({"id": rid, "instance": decision.idx,
                            "matched_blocks": decision.matched_blocks,
                            "routing": decision.reason})
        writer.write(chunk(f"data: {first}\n\n".encode()))
        await writer.drain()
        n = 0
        try:
            while True:
                kind, val = await sess.events.get()
                if kind == "tok":
                    ev = json.dumps({"token": val, "index": n})
                    writer.write(chunk(f"data: {ev}\n\n".encode()))
                    await writer.drain()
                    n += 1
                elif kind == "done":
                    writer.write(chunk(b"data: [DONE]\n\n"))
                    break
                else:                       # abort: well-formed tail
                    ev = json.dumps({"error": val})
                    writer.write(chunk(f"data: {ev}\n\n".encode()))
                    break
            writer.write(b"0\r\n\r\n")      # chunked terminator
            await writer.drain()
        except (ConnectionError, BrokenPipeError):
            # client hung up mid-stream: drop the session; the request
            # itself finishes on the engine (tokens just go unread)
            self.counters.aborted_streams += 1
            with self._lock:
                self._sessions.pop(rid, None)
