"""Observability for the serving plane: per-request tracing, Prometheus
text-format metrics, and the control-plane flight recorder.

Stdlib-only by design — no tracing SDK, no prometheus client. The three
subsystems share one file because they share one job: turning the
plane's decisions (routing, packing, migration, recovery) into evidence
that survives the process.

Span model (DESIGN.md §12)
--------------------------
A trace is one completion's timeline; the ROOT span's id IS the trace
id. Every other span parents either the root (accept / route / queue /
prefill / decode / migration hops) or a locally generated engine span
(prefill chunk -> its prefill span), so the tree is connected BY
CONSTRUCTION — no cross-process id coordination. Timestamps are
``time.monotonic()`` seconds in the INGRESS process's clock domain:
spans recorded inside a remote engine server are stamped with the
server's clock (``server_now``) and shifted by the proxy's RTT-estimated
offset on ingestion (``estimate_clock_offset`` — NTP-style midpoint of
the minimum-RTT sample), so one timeline holds across processes.

Ownership / thread safety
-------------------------
``Tracer`` and ``FlightRecorder`` are lock-protected (the ingress HTTP
thread records accept/route while the pump thread drains engine spans).
``EngineSpanRecorder`` is deliberately lock-free: it is owned by
whichever single thread steps its engine (the ingress pump, or a remote
engine server's serve loop) and drained from that same thread.

Copy of ``repro.serving.observe`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

# test seam: a spawned engine server started with this env var reports a
# skewed clock from server_now() — the proxy's offset estimation must
# correct it back out for the cross-process span test to pass
_SKEW_ENV = "REPRO_TRACE_CLOCK_SKEW"

_span_seq = itertools.count(1)


def server_now() -> float:
    """This process's span clock: monotonic seconds, plus the injected
    artificial skew when ``REPRO_TRACE_CLOCK_SKEW`` is set (inherited
    through spawn by test engine servers)."""
    return time.monotonic() + float(os.environ.get(_SKEW_ENV, 0) or 0)


def _new_span_id() -> str:
    """Process-unique span id (pid prefix makes it plane-unique in
    practice) — ids never coordinate across processes; tree
    connectivity comes from parenting, not id agreement."""
    return f"{os.getpid():x}.{next(_span_seq)}"


def make_span(trace_id: str, name: str, t0: float,
              t1: Optional[float] = None, *, parent: Optional[str] = None,
              origin: str = "", attrs: Optional[dict] = None,
              span_id: Optional[str] = None) -> dict:
    return {"trace": trace_id, "id": span_id or _new_span_id(),
            "parent": trace_id if parent is None else parent,
            "name": name, "t0": t0, "t1": t1, "origin": origin,
            "attrs": dict(attrs) if attrs else {}}


def estimate_clock_offset(call: Callable[[], float],
                          samples: int = 5) -> float:
    """Estimate a remote peer's clock offset from round trips: ``call``
    performs one blocking RPC returning the peer's ``server_now()``.
    Keeps the minimum-RTT sample (least queueing noise) and assumes the
    reply was stamped at the round trip's midpoint — classic NTP.
    ``remote_time - offset`` lands on this process's clock."""
    best_rtt, best_off = None, 0.0
    for _ in range(max(1, samples)):
        t0 = time.monotonic()
        ts = call()
        t1 = time.monotonic()
        rtt = t1 - t0
        if best_rtt is None or rtt < best_rtt:
            best_rtt, best_off = rtt, ts - (t0 + t1) / 2.0
    return best_off


def correct_spans(spans: Iterable[dict], offset: float) -> List[dict]:
    """Shift remote-stamped spans onto the local clock (in place)."""
    out = list(spans)
    if offset:
        for s in out:
            s["t0"] -= offset
            if s.get("t1") is not None:
                s["t1"] -= offset
    return out


def span_tree_ok(spans: List[dict]) -> Optional[str]:
    """Structural validation of one finished trace: exactly one root,
    every parent resolves, every span closed with t1 >= t0, children
    inside [root.t0 - eps, root.t1 + eps]. Returns None when the tree is
    sound, else a human-readable violation (test + bench assert on
    this)."""
    if not spans:
        return "empty trace"
    ids = {s["id"] for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    if len(roots) != 1:
        return f"{len(roots)} roots (want exactly 1)"
    root = roots[0]
    eps = 5e-3  # clock-correction residual tolerance
    for s in spans:
        if s["parent"] is not None and s["parent"] not in ids:
            return f"orphan span {s['name']!r}: parent {s['parent']!r}"
        if s.get("t1") is None:
            return f"span {s['name']!r} never closed"
        if s["t1"] < s["t0"]:
            return f"span {s['name']!r} ends before it starts"
        if s is not root and (s["t0"] < root["t0"] - eps
                              or s["t1"] > root["t1"] + eps):
            return (f"span {s['name']!r} [{s['t0']:.4f},{s['t1']:.4f}] "
                    f"outside root [{root['t0']:.4f},{root['t1']:.4f}]")
    return None


# ===================================================================== tracing
class EngineSpanRecorder:
    """Engine-side span hook (``engine.span_hook``): turns lifecycle
    callbacks into closed spans, buffered until ``drain``. Installed on
    a LocalInstance's engine by the orchestrator and on a remote
    server's engine the first time a trace context arrives over RPC.
    Only REGISTERED rids record (tracing off => every hook is a dict
    miss and nothing allocates)."""

    def __init__(self, origin: str = "engine"):
        self.origin = origin
        self._traces: Dict[int, str] = {}         # rid -> trace id
        self._open: Dict[int, Dict[str, dict]] = {}   # rid -> name -> span
        self._prefill_done: set = set()
        self._buf: List[dict] = []                # closed, awaiting drain

    def now(self) -> float:
        return server_now()

    def register(self, rid: int, trace_id: str):
        self._traces[rid] = trace_id

    def _forget(self, rid: int):
        self._traces.pop(rid, None)
        self._open.pop(rid, None)
        self._prefill_done.discard(rid)

    def _start(self, rid: int, name: str, t0: float,
               parent: Optional[str] = None) -> dict:
        span = make_span(self._traces[rid], name, t0, parent=parent,
                         origin=self.origin)
        self._open.setdefault(rid, {})[name] = span
        return span

    def _close(self, rid: int, name: str, t1: float, **attrs):
        span = self._open.get(rid, {}).pop(name, None)
        if span is not None:
            span["t1"] = t1
            span["attrs"].update(attrs)
            self._buf.append(span)

    # ------------------------------------------------- engine lifecycle
    def on_submit(self, req):
        if req.rid in self._traces:
            self._start(req.rid, "queue", self.now())

    def on_chunk(self, rid: int, start: int, n: int, t0: float, t1: float):
        """One executed prefill chunk [start, start+n); chunks parent
        the rid's prefill span (opened at the first chunk)."""
        if rid not in self._traces:
            return
        self._close(rid, "queue", t0)
        pre = self._open.get(rid, {}).get("prefill")
        if pre is None:
            pre = self._start(rid, "prefill", t0)
        chunk = make_span(self._traces[rid], "prefill_chunk", t0, t1,
                          parent=pre["id"], origin=self.origin,
                          attrs={"start": start, "n": n})
        self._buf.append(chunk)

    def on_activate(self, req, fresh_first: bool):
        """Request entered decode rotation (or finished at admission).
        ``fresh_first`` is True only when this activation SAMPLED the
        first token — a resumed/migrated continuation reopens decode
        without re-emitting first_token."""
        rid = req.rid
        if rid not in self._traces:
            return
        t = self.now()
        self._close(rid, "queue", t)
        if rid not in self._prefill_done:
            if "prefill" not in self._open.get(rid, {}):
                # wave path: whole prompt in one forward, no chunk spans
                self._start(rid, "prefill", t)
            self._close(rid, "prefill", t)
            self._prefill_done.add(rid)
        else:
            self._close(rid, "prefill", t)
        if fresh_first:
            self._buf.append(make_span(self._traces[rid], "first_token",
                                       t, t, origin=self.origin))
        self._start(rid, "decode", t)

    def on_resume(self, req, phase: str):
        """Migrated-in continuation bound on THIS engine: reopen the
        span the destination now owns (decode, or prefill for a
        mid-prefill hop — its remaining chunks reopen prefill anyway)."""
        if req.rid in self._traces and phase == "decode":
            self._prefill_done.add(req.rid)
            self._start(req.rid, "decode", self.now())

    def on_finish(self, req):
        rid = req.rid
        if rid not in self._traces:
            return
        t = self.now()
        for name in list(self._open.get(rid, {})):
            self._close(rid, name, t)
        self._forget(rid)

    def on_pause(self, rid: int):
        """Request paused for migration off this engine: close whatever
        is open here — the destination opens its own continuation."""
        if rid not in self._traces:
            return
        t = self.now()
        for name in list(self._open.get(rid, {})):
            self._close(rid, name, t, paused=True)
        self._forget(rid)

    def on_preempt(self, rid: int):
        """Preempted back to this engine's own queue: close open spans
        (the replay re-opens them) but keep the registration."""
        if rid not in self._traces:
            return
        t = self.now()
        for name in list(self._open.get(rid, {})):
            self._close(rid, name, t, preempted=True)
        self._prefill_done.discard(rid)

    def drain(self) -> List[dict]:
        """Closed spans since the last drain (open spans stay put)."""
        if not self._buf:
            return []
        out, self._buf = self._buf, []
        return out


class Tracer:
    """Ingress/orchestrator-side trace aggregator: owns trace ids, the
    root span, ingress-local spans (accept/route/migration hops), and
    ingestion of engine-recorded spans; finished traces go to the JSONL
    sink plus a bounded in-memory ring (tests, debugging)."""

    def __init__(self, out_path: Optional[str] = None, keep: int = 256):
        self._lock = threading.Lock()
        self._out_path = out_path
        self._out = None
        self._live: Dict[int, dict] = {}        # rid -> record
        self._by_trace: Dict[str, int] = {}     # trace id -> rid
        self.finished: collections.deque = collections.deque(maxlen=keep)
        self.exported = 0
        self.dropped_spans = 0   # spans for unknown/finished traces

    # ------------------------------------------------------- lifecycle
    def begin(self, rid: int, t0: Optional[float] = None,
              **attrs) -> str:
        """Open a trace for ``rid``; returns the trace id (also the
        response's X-Request-Id). ``t0`` backdates the root to when the
        request actually arrived (the ingress parses before it
        begins — children must stay inside the root window)."""
        trace_id = f"req-{rid}-{_new_span_id()}"
        root = make_span(trace_id, "request",
                         server_now() if t0 is None else t0,
                         origin="ingress", attrs=attrs, span_id=trace_id)
        root["parent"] = None
        with self._lock:
            self._live[rid] = {"trace_id": trace_id, "rid": rid,
                               "spans": [root]}
            self._by_trace[trace_id] = rid
        return trace_id

    def ctx(self, rid: int) -> Optional[dict]:
        """The propagation context that rides RPC frames."""
        with self._lock:
            rec = self._live.get(rid)
            return ({"trace_id": rec["trace_id"], "rid": rid}
                    if rec else None)

    def trace_id(self, rid: int) -> Optional[str]:
        with self._lock:
            rec = self._live.get(rid)
            return rec["trace_id"] if rec else None

    def span(self, rid: int, name: str, t0: float,
             t1: Optional[float] = None, *, origin: str = "ingress",
             attrs: Optional[dict] = None) -> Optional[dict]:
        """Record one root-parented span (t1 defaults to now)."""
        with self._lock:
            rec = self._live.get(rid)
            if rec is None:
                self.dropped_spans += 1
                return None
            s = make_span(rec["trace_id"], name, t0,
                          server_now() if t1 is None else t1,
                          origin=origin, attrs=attrs)
            rec["spans"].append(s)
            return s

    def ingest(self, spans: Iterable[dict]):
        """Bulk-add engine-recorded spans (already clock-corrected by
        the proxy); spans whose trace has finished/never existed are
        counted and dropped, never raised."""
        with self._lock:
            for s in spans:
                rid = self._by_trace.get(s.get("trace"))
                if rid is None:
                    self.dropped_spans += 1
                    continue
                self._live[rid]["spans"].append(s)

    def annotate(self, rid: int, **attrs):
        with self._lock:
            rec = self._live.get(rid)
            if rec is not None:
                rec["spans"][0]["attrs"].update(attrs)

    def finish(self, rid: int, **attrs) -> Optional[dict]:
        """Close the root span, export the trace as one JSONL line, and
        move it to the finished ring. Returns the record (None if the
        rid has no live trace).

        SLO attainment: when the closing attrs carry a ``deadline_ms``
        (the request's wall-clock completion target), the tracer stamps
        ``latency_ms`` and ``deadline_met`` from the root span's own
        extent — the one clock that saw both the accept and the finish."""
        with self._lock:
            rec = self._live.pop(rid, None)
            if rec is None:
                return None
            del self._by_trace[rec["trace_id"]]
            root = rec["spans"][0]
            root["t1"] = server_now()
            if attrs.get("deadline_ms") is not None:
                lat_ms = (root["t1"] - root["t0"]) * 1e3
                attrs["latency_ms"] = lat_ms
                attrs["deadline_met"] = bool(lat_ms <= attrs["deadline_ms"])
            root["attrs"].update(attrs)
            self.finished.append(rec)
            self._export(rec)
            return rec

    def _export(self, rec: dict):
        if not self._out_path:
            return
        if self._out is None:
            self._out = open(self._out_path, "a", encoding="utf-8")
        self._out.write(json.dumps(rec) + "\n")
        self._out.flush()
        self.exported += 1

    def live_rids(self) -> List[int]:
        with self._lock:
            return list(self._live)

    def close(self):
        with self._lock:
            if self._out is not None:
                self._out.close()
                self._out = None


# ================================================== Prometheus text format
_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(v) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """A scrape's worth of metric families, rendered to Prometheus text
    exposition format. Rebuilt per scrape from the pump's immutable
    mirror — there is no background mutation, so rendering needs no
    locks. Histogram bucket counts reflect the telemetry's rolling
    windows (valid exposition format; scrape-to-scrape monotonicity is
    not promised, and DESIGN.md §12 says so)."""

    def __init__(self):
        self._families: Dict[str, dict] = {}
        self._order: List[str] = []

    def _family(self, name: str, kind: str, help_text: str) -> dict:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        fam = self._families.get(name)
        if fam is None:
            fam = {"type": kind, "help": help_text,
                   "samples": [], "hists": []}
            self._families[name] = fam
            self._order.append(name)
        elif fam["type"] != kind:
            raise ValueError(f"{name}: redeclared {fam['type']} as {kind}")
        return fam

    def _sample(self, name, kind, help_text, value, labels):
        labels = labels or {}
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name {k!r}")
        self._family(name, kind, help_text)["samples"].append(
            (dict(labels), float(value)))

    def counter(self, name, help_text, value, labels=None):
        self._sample(name, "counter", help_text, value, labels)

    def gauge(self, name, help_text, value, labels=None):
        self._sample(name, "gauge", help_text, value, labels)

    def histogram(self, name, help_text, observations, buckets,
                  labels=None):
        """One labelset's histogram from raw observations; ``buckets``
        are finite upper bounds (+Inf is appended by the renderer)."""
        bounds = sorted(float(b) for b in buckets)
        obs = [float(x) for x in observations]
        self._family(name, "histogram", help_text)["hists"].append(
            (dict(labels or {}), bounds, obs))

    def render(self) -> str:
        lines = []
        for name in self._order:
            fam = self._families[name]
            lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for labels, value in fam["samples"]:
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
            for labels, bounds, obs in fam["hists"]:
                acc = 0
                for b in bounds:
                    acc = sum(1 for x in obs if x <= b)
                    lb = dict(labels, le=_fmt_value(b))
                    lines.append(f"{name}_bucket{_fmt_labels(lb)} {acc}")
                lb = dict(labels, le="+Inf")
                lines.append(f"{name}_bucket{_fmt_labels(lb)} {len(obs)}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(sum(obs))}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{len(obs)}")
        return "\n".join(lines) + "\n"


def _parse_label_block(s: str, lineno: int) -> dict:
    labels = {}
    i = 0
    while i < len(s):
        m = re.match(r"([a-zA-Z_][a-zA-Z0-9_]*)=\"", s[i:])
        if not m:
            raise ValueError(f"line {lineno}: bad label syntax at {s[i:]!r}")
        key = m.group(1)
        i += m.end()
        val, closed = [], False
        while i < len(s):
            ch = s[i]
            if ch == "\\":
                if i + 1 >= len(s):
                    raise ValueError(f"line {lineno}: dangling escape")
                nxt = s[i + 1]
                if nxt not in ('"', "\\", "n"):
                    raise ValueError(
                        f"line {lineno}: bad escape \\{nxt} in label value")
                val.append("\n" if nxt == "n" else nxt)
                i += 2
            elif ch == '"':
                i += 1
                closed = True
                break
            else:
                val.append(ch)
                i += 1
        if not closed:
            raise ValueError(f"line {lineno}: unterminated label value")
        labels[key] = "".join(val)
        if i < len(s):
            if s[i] != ",":
                raise ValueError(f"line {lineno}: expected ',' after label")
            i += 1
    return labels


def _split_sample(line: str, lineno: int):
    m = re.match(r"([a-zA-Z_:][a-zA-Z0-9_:]*)", line)
    if not m:
        raise ValueError(f"line {lineno}: bad sample name: {line!r}")
    name, rest = m.group(1), line[m.end():]
    labels = {}
    if rest.startswith("{"):
        i, in_q, esc = 1, False, False
        while i < len(rest):
            ch = rest[i]
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_q = not in_q
            elif ch == "}" and not in_q:
                break
            i += 1
        if i >= len(rest):
            raise ValueError(f"line {lineno}: unterminated label block")
        labels = _parse_label_block(rest[1:i], lineno)
        rest = rest[i + 1:]
    parts = rest.split()
    if len(parts) not in (1, 2):
        raise ValueError(f"line {lineno}: want 'name[labels] value "
                         f"[timestamp]', got {line!r}")
    try:
        value = float(parts[0])
    except ValueError:
        raise ValueError(f"line {lineno}: bad value {parts[0]!r}") from None
    if len(parts) == 2 and not re.match(r"-?\d+$", parts[1]):
        raise ValueError(f"line {lineno}: bad timestamp {parts[1]!r}")
    return name, labels, value


def parse_prometheus(text: str) -> dict:
    """Strict parser/validator for Prometheus text exposition format —
    the conformance gate CI scrapes ``GET /metrics`` through. Enforces:
    every sample belongs to a ``# TYPE``-declared family (declared
    before its samples, once), names/labels/values are well-formed, and
    each histogram labelset has sorted buckets with non-decreasing
    cumulative counts, a ``+Inf`` bucket, and ``_count`` == the +Inf
    bucket. Returns ``{family: {type, help, samples}}``; raises
    ValueError with the offending line on any violation."""
    families: Dict[str, dict] = {}
    seen_samples: set = set()

    def _owner(name: str, lineno: int) -> str:
        if name in families:
            return name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[: -len(suffix)]
                if families.get(base, {}).get("type") == "histogram":
                    return base
        raise ValueError(f"line {lineno}: sample {name!r} has no "
                         f"# TYPE declaration")

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            m = re.match(r"#\s+(HELP|TYPE)\s+([a-zA-Z_:][a-zA-Z0-9_:]*)"
                         r"(?:\s+(.*))?$", line)
            if not m:
                continue   # plain comment
            kind, name, arg = m.group(1), m.group(2), m.group(3) or ""
            fam = families.setdefault(
                name, {"type": None, "help": None, "samples": []})
            if kind == "HELP":
                if fam["help"] is not None:
                    raise ValueError(f"line {lineno}: duplicate HELP {name}")
                fam["help"] = arg
            else:
                if fam["type"] is not None:
                    raise ValueError(f"line {lineno}: duplicate TYPE {name}")
                if arg not in ("counter", "gauge", "histogram", "summary",
                               "untyped"):
                    raise ValueError(f"line {lineno}: bad type {arg!r}")
                if name in seen_samples:
                    raise ValueError(
                        f"line {lineno}: TYPE {name} after its samples")
                fam["type"] = arg
            continue
        name, labels, value = _split_sample(line, lineno)
        base = _owner(name, lineno)
        seen_samples.add(base)
        families[base]["samples"].append((name, labels, value))

    for name, fam in families.items():
        if fam["type"] is None:
            raise ValueError(f"family {name}: HELP without TYPE")
        if fam["type"] != "histogram":
            continue
        groups: Dict[tuple, dict] = {}
        for sname, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            g = groups.setdefault(key, {"buckets": [], "sum": None,
                                        "count": None})
            if sname == f"{name}_bucket":
                if "le" not in labels:
                    raise ValueError(f"{name}: bucket without le label")
                g["buckets"].append((float(labels["le"]), value))
            elif sname == f"{name}_sum":
                g["sum"] = value
            elif sname == f"{name}_count":
                g["count"] = value
            else:
                raise ValueError(f"{name}: stray sample {sname}")
        for key, g in groups.items():
            bk = sorted(g["buckets"])
            if not bk or bk[-1][0] != float("inf"):
                raise ValueError(f"{name}{dict(key)}: no +Inf bucket")
            counts = [c for _, c in bk]
            if any(b > a for a, b in zip(counts[1:], counts)):
                raise ValueError(f"{name}{dict(key)}: bucket counts "
                                 f"not cumulative")
            if g["count"] is None or g["sum"] is None:
                raise ValueError(f"{name}{dict(key)}: missing _sum/_count")
            if g["count"] != counts[-1]:
                raise ValueError(f"{name}{dict(key)}: _count "
                                 f"{g['count']} != +Inf bucket {counts[-1]}")
    return families


# ======================================================== flight recorder
class FlightRecorder:
    """Bounded ring of structured control-plane events — WHY the plane
    did what it did (controller votes with their inputs, grow/shrink,
    migration phase timings, quarantines, respawns, routing verdicts).
    ``GET /debug/flightrec`` serves ``dump()``; crash-recovery events
    auto-dump to ``dump_path`` when one is configured, so a dead soak
    still leaves evidence on disk."""

    def __init__(self, capacity: int = 512,
                 dump_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = itertools.count(1)
        self.dump_path = dump_path
        self.dumps = 0

    def record(self, kind: str, **fields) -> dict:
        evt = dict(seq=next(self._seq), t=time.monotonic(),
                   wall=time.time(), kind=kind, **fields)
        with self._lock:
            self._ring.append(evt)
        return evt

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evts = list(self._ring)
        return evts if kind is None else [e for e in evts
                                          if e["kind"] == kind]

    def dump(self) -> dict:
        with self._lock:
            evts = list(self._ring)
        return {"capacity": self._ring.maxlen, "recorded": evts[-1]["seq"]
                if evts else 0, "events": evts}

    def auto_dump(self, reason: str) -> Optional[str]:
        """Persist the ring to ``dump_path`` (overwrite: latest crash
        wins). Failures are swallowed — the recorder must never take
        down the recovery it is documenting."""
        if not self.dump_path:
            return None
        try:
            payload = self.dump()
            payload["reason"] = reason
            with open(self.dump_path, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            self.dumps += 1
            return self.dump_path
        except OSError:
            return None
