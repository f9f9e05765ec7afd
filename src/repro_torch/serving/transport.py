"""Message-framed RPC wire protocol for the distributed serving plane.

The multi-process deployment (serving/remote_engine.py) runs each paged
``Engine`` in its own OS process behind an engine-server loop; everything
the orchestrator exchanges with it — admissions, per-step telemetry,
controller plans, and the column-keyed block-migration payloads of
``serving/paged_kv.export_blocks`` — travels through THIS module as
length-prefixed frames over a stream socket. Two endpoint families share
the one frame format:

* ``unix`` — an AF_UNIX path (same-host child processes, the PR-4
  rendezvous);
* ``tcp://host:port`` — AF_INET between hosts: the multi-host pod
  (launch/pod.py) runs engine servers as listening TCP endpoints and
  the orchestrator connects with retry/backoff (a server that is still
  booting looks exactly like a connection refused). A half-open or
  reset TCP peer surfaces as ``TransportClosed`` from the next
  send/recv — the same crash signal the AF_UNIX plane uses, so crash
  recovery is transport-blind.

No shared memory anywhere: a frame is the only way state crosses a
process boundary, which is what makes the plane deployable across
machines (FlexPipe's "explicit wire protocol" requirement).

Frame layout (all integers big-endian)::

    +--------+-----------+----------------------+
    | u32    | u8        | payload              |
    | length | codec tag | ``length - 1`` bytes |
    +--------+-----------+----------------------+

Codec tag ``M`` is msgpack with two extension conventions — numpy
arrays as ``{b"__nd__": (dtype str, shape, C-bytes)}`` and
``serving.engine.Request`` as ``{b"__req__": field dict}`` — so the hot
payloads (block data, token arrays) move as raw bytes with zero pickle
overhead. Tag ``P`` is a pickle fallback for messages msgpack cannot
express (configs, arbitrary trees: the one-time ``init`` message). The
receiver dispatches on the tag, so both ends can mix codecs freely and
a container without msgpack still interoperates.

RPC on top of frames is deliberately minimal: requests are
``{"id": n, "op": name, "args": [...], "kw": {...}}``, replies are
``{"id": n, "ok": True, "result": ...}`` or ``{"id": n, "ok": False,
"error": repr, "kind": exception-class-name}``. ``Rpc.call`` blocks for
the matching reply; ``Rpc.call_async`` pipelines — the server processes
in order, so a caller can keep a slow operation (a phase-1 block
import) in flight on one peer while it keeps stepping another: that is
the overlap in "overlapped migration".

``drain_pendings`` is the control plane's batched poll: fan a request
out to every peer with ``call_async``, then ONE ``selectors``-
multiplexed wait drains all replies as they land. The callers' wall
time is bounded by the slowest peer, not the sum of round trips, and a
peer that dies mid-poll resolves its entries to ``TransportClosed``
instead of aborting the drain — crash detection folds into the same
poll that collects results.

Copy of ``repro.serving.transport`` for the port, whose orchestrator
catches its exception types and waits on its ``Pending`` /
``drain_pendings``. The msgpack hook rebuilds the port's ``Request`` and
``RequestSpec``. A migration payload is numpy throughout — a bf16 pool
ships its blocks as raw ``uint16`` bits (``paged_kv.export_blocks``) — so
it needs no framework type on the wire. The engine server and its
proxy (``remote_engine.py``) serve and call over it.
"""
from __future__ import annotations

import io
import os
import pickle
import select
import selectors
import socket
import struct
import tempfile
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

try:  # optional: the frame format downgrades to pickle without it
    import msgpack  # type: ignore
except ImportError:  # pragma: no cover - CI bakes msgpack in
    msgpack = None

_LEN = struct.Struct(">I")
TAG_MSGPACK = b"M"
TAG_PICKLE = b"P"
MAX_FRAME = 1 << 31  # sanity bound: a corrupt length prefix fails loudly
_RECV_CHUNK = 1 << 16

# receive-side allocation bound (satellite: a corrupt/hostile length
# prefix must fail the connection, not attempt a multi-GB bytearray).
# Block-migration payloads on real configs run to tens of MB; 256 MB
# leaves an order of magnitude of headroom while still refusing the
# 2^31-ish garbage a misframed stream produces.
DEFAULT_MAX_RECV_FRAME = int(os.environ.get("REPRO_MAX_FRAME_BYTES",
                                            str(1 << 28)))


class TransportError(RuntimeError):
    """Framing/codec violation on a live connection."""


class TransportClosed(TransportError):
    """Peer hung up (EOF mid-frame, reset, or closed socket) — the
    signal the orchestrator's crash recovery (re-queue + replay) keys
    on, identical for AF_UNIX children and TCP peers on other hosts."""


class NotAwaited(TransportClosed):
    """A call left unresolved when ``drain_pendings(first_failure=True)``
    stopped at another peer's failure."""


class RpcTimeout(TransportError):
    """A reply missed its per-call deadline with the socket still OPEN —
    the *hung* signal (GC pause, network blackhole, livelocked worker),
    deliberately distinct from ``TransportClosed`` (*dead*): a hung peer
    may still hold authoritative request state, so the orchestrator
    probes (heartbeat) and quarantines before replaying, instead of
    assuming the process is gone."""


class FrameTooLarge(TransportError):
    """Incoming length prefix exceeds the receive bound. The stream is
    unsynchronized at this point (the oversized frame was never read),
    so the connection is failed — callers must not retry on it."""


# Fault-injection seam (serving/faults.py): when installed, the hook is
# consulted on every labeled ``Connection.send`` and may delay the frame
# or swallow it entirely (drop / partition / half-open). ``None`` —
# the default — costs one attribute check per send. Connections without
# a ``peer_label`` (servers' child-side sockets, unlabeled tests) are
# never faulted, so a REPRO_FAULTS plan inherited through the
# environment by worker processes is inert there.
_FAULT_HOOK: Optional[Callable[["Connection"], bool]] = None


def set_fault_hook(hook: Optional[Callable[["Connection"], bool]]):
    """Install (or clear, with ``None``) the send-side fault hook. The
    hook receives the ``Connection`` and returns False to swallow the
    frame. Installed by ``repro.serving.faults`` — not called directly
    by user code."""
    global _FAULT_HOOK
    _FAULT_HOOK = hook


class RemoteError(RuntimeError):
    """An exception raised INSIDE the peer's handler, re-raised at the
    caller with the remote repr. ``kind`` preserves the remote class
    name so callers can branch (e.g. on ``OutOfBlocks``) without
    importing anything."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"{kind}: {message}")
        self.kind = kind


# ------------------------------------------------------------------ codecs
def _np_encode(arr: np.ndarray):
    a = np.ascontiguousarray(arr)
    return {b"__nd__": (str(a.dtype), list(a.shape), a.tobytes())}


def _msgpack_default(obj):
    if isinstance(obj, np.ndarray):
        return _np_encode(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if type(obj).__name__ == "Request":
        import dataclasses
        return {b"__req__": dataclasses.asdict(obj)}
    if type(obj).__name__ == "RequestSpec":
        import dataclasses
        # asdict recurses into the nested SamplingParams; the decode
        # hook rebuilds it
        return {b"__spec__": dataclasses.asdict(obj)}
    raise TypeError(f"not msgpack-encodable: {type(obj)!r}")


def _msgpack_object_hook(obj: dict):
    if b"__nd__" in obj and len(obj) == 1:
        dtype, shape, buf = obj[b"__nd__"]
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
    if b"__req__" in obj and len(obj) == 1:
        from repro_torch.serving.engine import Request
        return Request(**obj[b"__req__"])
    if b"__spec__" in obj and len(obj) == 1:
        from repro_torch.serving.request import RequestSpec, SamplingParams
        d = dict(obj[b"__spec__"])
        d["sampling"] = SamplingParams(**d["sampling"])
        return RequestSpec(**d)
    return obj


def encode(obj: Any, prefer: str = "msgpack") -> bytes:
    """Serialize ``obj`` to one frame body (tag byte + payload)."""
    if prefer == "msgpack" and msgpack is not None:
        try:
            body = msgpack.packb(obj, default=_msgpack_default,
                                 use_bin_type=True, strict_types=False)
            return TAG_MSGPACK + body
        except (TypeError, ValueError):
            pass  # not msgpack-shaped (configs, pytrees): pickle frame
    return TAG_PICKLE + pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def decode(frame: bytes) -> Any:
    tag, body = frame[:1], frame[1:]
    if tag == TAG_MSGPACK:
        if msgpack is None:  # pragma: no cover
            raise TransportError("msgpack frame but msgpack unavailable")
        return msgpack.unpackb(body, object_hook=_msgpack_object_hook,
                               raw=False, strict_map_key=False)
    if tag == TAG_PICKLE:
        return pickle.loads(body)
    raise TransportError(f"unknown codec tag {tag!r}")


# --------------------------------------------------------------- endpoints
def parse_endpoint(address: str) -> Tuple[str, Any]:
    """``tcp://host:port`` -> ``("tcp", (host, port))``; ``unix://path``
    or a bare filesystem path -> ``("unix", path)``."""
    if address.startswith("tcp://"):
        host, sep, port = address[len("tcp://"):].rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"malformed tcp endpoint {address!r} "
                             "(want tcp://host:port)")
        return "tcp", (host, int(port))
    if address.startswith("unix://"):
        return "unix", address[len("unix://"):]
    return "unix", address


def listener_address() -> str:
    """Fresh AF_UNIX rendezvous path for one parent<->child connection."""
    return os.path.join(tempfile.gettempdir(),
                        f"repro-engine-{os.getpid()}-{uuid.uuid4().hex}.sock")


def free_tcp_endpoint(host: str = "127.0.0.1") -> str:
    """A currently-free ``tcp://host:port`` (bind port 0, read it back).
    Launcher/test convenience; the port can in principle be reused by
    another process before the caller binds it."""
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        probe.bind((host, 0))
        return f"tcp://{host}:{probe.getsockname()[1]}"
    finally:
        probe.close()


def bound_endpoint(srv: socket.socket) -> str:
    """The concrete endpoint a listener bound (resolves ``port 0``)."""
    if srv.family == socket.AF_INET:
        host, port = srv.getsockname()[:2]
        return f"tcp://{host}:{port}"
    return srv.getsockname()


def _tune_tcp(sock: socket.socket):
    # frames are small and latency-critical (one RPC per control tick):
    # never Nagle-delay them; keepalive turns a silently half-open peer
    # (host died, no RST ever arrives) into an eventual TransportClosed
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)


def listen(address: str) -> socket.socket:
    """Bind + listen on a ``tcp://`` or AF_UNIX endpoint."""
    kind, target = parse_endpoint(address)
    if kind == "tcp":
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(target)
        srv.listen(16)
    else:
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(target)
        srv.listen(1)
    return srv


def accept(srv: socket.socket, timeout: Optional[float] = 60.0) -> "Connection":
    srv.settimeout(timeout)
    try:
        sock, _ = srv.accept()
    except socket.timeout as e:
        raise TransportError("engine server never connected") from e
    finally:
        srv.settimeout(None)
    sock.settimeout(None)
    if sock.family == socket.AF_INET:
        _tune_tcp(sock)
    return Connection(sock)


# errors a retry can plausibly outwait: the server exists but hasn't
# bound/listened yet, or is mid-restart. Anything else (DNS failure on
# a typo'd host, EACCES, EADDRNOTAVAIL, ...) is a misconfiguration that
# every retry would reproduce — fail fast instead of eating the timeout.
_RETRYABLE_CONNECT = (ConnectionRefusedError, ConnectionResetError,
                      ConnectionAbortedError, FileNotFoundError,
                      socket.timeout)

BACKOFF_CAP = 0.5  # connect-retry ceiling: a booting server binds fast


def backoff_delays(initial: float = 0.02, cap: float = BACKOFF_CAP):
    """The connect-retry schedule: monotone doubling from ``initial``,
    capped at ``cap``. Extracted so tests can assert the schedule
    itself (capped, monotone) independently of wall time."""
    delay = initial
    while True:
        yield delay
        delay = min(delay * 2, cap)


def connect(address: str, timeout: float = 60.0,
            retry_interval: float = 0.02,
            abort: Optional[Callable[[], Optional[str]]] = None
            ) -> "Connection":
    """Connect to a listening endpoint, retrying with backoff until
    ``timeout``. A not-yet-listening peer (pod launcher spawned the
    server a moment ago; its socket isn't bound yet) raises
    ConnectionRefusedError / FileNotFoundError on each attempt — those
    retry, and only the deadline turns them into ``TransportError``;
    permanently-failing errors (unresolvable host, permissions) raise
    immediately. ``abort`` is polled between retries: returning a
    message stops the loop at once (e.g. "the spawned server process
    already exited" — no point waiting out the deadline)."""
    kind, target = parse_endpoint(address)
    family = socket.AF_INET if kind == "tcp" else socket.AF_UNIX
    deadline = time.monotonic() + timeout
    delays = backoff_delays(retry_interval)
    while True:
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.settimeout(max(0.05, deadline - time.monotonic()))
        try:
            sock.connect(target)
            break
        except _RETRYABLE_CONNECT as e:
            sock.close()
            reason = abort() if abort is not None else None
            if reason:
                raise TransportError(
                    f"connect to {address} aborted: {reason}") from e
            delay = next(delays)
            if time.monotonic() + delay >= deadline:
                raise TransportError(
                    f"connect to {address} failed within {timeout:.1f}s: "
                    f"{e}") from e
            time.sleep(delay)
        except OSError as e:
            sock.close()
            raise TransportError(
                f"connect to {address} failed ({e}); not retrying — "
                "this error does not look transient") from e
    sock.settimeout(None)
    if kind == "tcp":
        _tune_tcp(sock)
    return Connection(sock)


# ------------------------------------------------------------- connections
class Connection:
    """One framed, bidirectional message stream over a socket.

    Receive buffering is in-object (not a ``makefile`` wrapper) so the
    multiplexed poll can distinguish "kernel has data" (``select`` on
    ``fileno()``) from "bytes already sit in our buffer"
    (``has_buffered()`` — possibly a partial frame, whose tail is then
    read blocking) — buffered bytes never wake ``select``, so the poll
    must drain them explicitly before sleeping."""

    def __init__(self, sock: socket.socket,
                 max_frame: Optional[int] = None):
        self._sock = sock
        self._rxbuf = bytearray()
        self.tx_frames = 0
        self.rx_frames = 0
        self.tx_bytes = 0
        self.rx_bytes = 0
        # identity for the fault-injection seam: None (the default)
        # means "never fault this connection"
        self.peer_label: Optional[str] = None
        self.max_frame = (DEFAULT_MAX_RECV_FRAME if max_frame is None
                          else max_frame)
        self.last_rx = time.monotonic()

    def fileno(self) -> int:
        return self._sock.fileno()

    def has_buffered(self) -> bool:
        return bool(self._rxbuf)

    def local_host(self) -> str:
        """This end's address on the connection: the address over which
        the peer reaches this host (loopback for an AF_UNIX socket)."""
        name = self._sock.getsockname()
        return name[0] if isinstance(name, tuple) else "127.0.0.1"

    def wait_readable(self, timeout: float) -> bool:
        """True once bytes are available (buffered or kernel-side),
        False if ``timeout`` elapses first. The deadline clock of
        ``Rpc._wait`` sleeps here instead of in a blocking recv."""
        if self._rxbuf:
            return True
        readable, _, _ = select.select([self._sock], [], [],
                                       max(0.0, timeout))
        return bool(readable)

    def send(self, obj: Any):
        frame = encode(obj)
        if len(frame) >= MAX_FRAME:
            raise TransportError(f"frame too large: {len(frame)} bytes")
        if _FAULT_HOOK is not None and not _FAULT_HOOK(self):
            return  # injected loss: the frame never reaches the wire
        try:
            self._sock.sendall(_LEN.pack(len(frame)) + frame)
        except (BrokenPipeError, ConnectionResetError, OSError) as e:
            raise TransportClosed(f"send on dead connection: {e}") from e
        self.tx_frames += 1
        self.tx_bytes += len(frame) + _LEN.size

    def _fill(self, n: int):
        while len(self._rxbuf) < n:
            try:
                chunk = self._sock.recv(_RECV_CHUNK)
            except (ConnectionResetError, BrokenPipeError, OSError) as e:
                raise TransportClosed(f"recv on dead connection: {e}") from e
            if not chunk:
                raise TransportClosed(
                    f"peer closed mid-frame (wanted {n} bytes, "
                    f"got {len(self._rxbuf)})")
            self._rxbuf += chunk
            self.last_rx = time.monotonic()

    def _read_exact(self, n: int) -> bytes:
        self._fill(n)
        out = bytes(memoryview(self._rxbuf)[:n])
        del self._rxbuf[:n]
        return out

    def recv(self) -> Any:
        (length,) = _LEN.unpack(self._read_exact(_LEN.size))
        if not 0 < length < MAX_FRAME:
            raise TransportError(f"corrupt frame length {length}")
        if length > self.max_frame:
            # checked BEFORE any allocation; the stream is now
            # unsynchronized (we never consumed the frame), so fail the
            # connection rather than let a retry read garbage
            self.close()
            raise FrameTooLarge(
                f"incoming frame of {length} bytes exceeds the "
                f"{self.max_frame}-byte receive bound (corrupt length "
                "prefix or hostile peer); connection failed")
        frame = self._read_exact(length)
        self.rx_frames += 1
        self.rx_bytes += length + _LEN.size
        return decode(frame)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def socketpair() -> tuple:
    """In-process connected pair (tests, threads) with the same framing."""
    a, b = socket.socketpair()
    return Connection(a), Connection(b)


# -------------------------------------------------------------------- rpc
class Pending:
    """Handle for a pipelined ``call_async``; ``wait()`` blocks until the
    matching reply arrives (draining any earlier pipelined replies).
    ``deadline`` (a ``time.monotonic`` instant, or None) bounds the wait:
    past it, ``wait()`` raises ``RpcTimeout`` and ``drain_pendings``
    resolves the entry to ``("hung", ...)``."""

    def __init__(self, rpc: "Rpc", call_id: int,
                 deadline: Optional[float] = None):
        self._rpc = rpc
        self.call_id = call_id
        self.deadline = deadline

    def ready(self) -> bool:
        return self.call_id in self._rpc._replies

    def wait(self) -> Any:
        return self._rpc._wait(self.call_id, deadline=self.deadline)


class Rpc:
    """Client side: request/reply (+ pipelining) over a Connection.

    ``call_timeout`` (seconds, None = unbounded) stamps a monotonic
    deadline onto every ``Pending`` this client issues — the per-call
    deadline clock the orchestrator's hung-peer detection keys on."""

    def __init__(self, conn: Connection,
                 call_timeout: Optional[float] = None):
        self.conn = conn
        self.call_timeout = call_timeout
        self._next_id = 0
        self._replies: Dict[int, Any] = {}

    def call_async(self, op: str, *args, _trace=None, **kw) -> Pending:
        self._next_id += 1
        cid = self._next_id
        msg = {"id": cid, "op": op, "args": list(args), "kw": kw}
        if _trace is not None:
            # trace-context propagation (serving/observe.py): rides the
            # existing frame, invisible to the dispatched handler — the
            # server's ``_on_trace`` dispatch hook consumes it
            msg["trace"] = _trace
        self.conn.send(msg)
        deadline = (None if self.call_timeout is None
                    else time.monotonic() + self.call_timeout)
        return Pending(self, cid, deadline=deadline)

    def call(self, op: str, *args, **kw) -> Any:
        return self.call_async(op, *args, **kw).wait()

    def call_timed(self, op: str, timeout: float, *args, **kw) -> Any:
        """One call with an explicit deadline, regardless of
        ``call_timeout`` — the heartbeat probe's entry point."""
        pending = self.call_async(op, *args, **kw)
        pending.deadline = time.monotonic() + timeout
        return pending.wait()

    def _pump_one(self):
        """Receive exactly one reply frame into the reply buffer."""
        reply = self.conn.recv()
        self._replies[reply["id"]] = reply

    def _take(self, call_id: int) -> Any:
        """Resolve an already-received reply (raises RemoteError for
        error replies). The reply MUST be present — ``_wait`` /
        ``drain_pendings`` guarantee that before calling."""
        reply = self._replies.pop(call_id)
        if not reply.get("ok"):
            raise RemoteError(reply.get("kind", "RuntimeError"),
                              reply.get("error", "remote failure"))
        return reply.get("result")

    def _wait(self, call_id: int,
              deadline: Optional[float] = None) -> Any:
        while call_id not in self._replies:
            if deadline is not None:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    raise RpcTimeout(
                        f"call {call_id} ({self.conn.peer_label or 'peer'})"
                        " missed its deadline with the socket still open")
                if not self.conn.wait_readable(budget):
                    continue  # re-check the clock, then raise
            self._pump_one()
        return self._take(call_id)

    def close(self):
        self.conn.close()


def drain_pendings(pendings: List[Any],
                   timeout: Optional[float] = None, *,
                   first_failure: bool = False) -> List[tuple]:
    """The batched control-plane poll: resolve MANY pipelined calls —
    across any number of connections — in one ``selectors`` wait.

    ``pendings`` may mix transport ``Pending``s with any already-
    resolved stand-in exposing ``wait()`` (a local instance's
    ``Completed``). Returns a list parallel to the input, each entry one
    of::

        ("ok",     result)            reply arrived, handler succeeded
        ("error",  RemoteError)       reply arrived, handler raised
        ("closed", TransportClosed)   the peer died before replying
        ("hung",   RpcTimeout)        per-call deadline passed, socket
                                      still open — the peer may be
                                      stalled, partitioned, or half-open

    A dead peer resolves ALL of its outstanding entries to ``closed``
    without disturbing other peers' entries — the caller folds crash
    detection into the same poll that collects results. Wall time is
    bounded by the slowest peer (replies are consumed as they land),
    not the sum of round trips.

    A ``Pending`` carrying a deadline (``Rpc.call_timeout``) that
    expires mid-drain resolves to ``("hung", RpcTimeout)`` — only that
    entry: the connection stays registered for its other pendings, and
    healthy peers are untouched. This is what keeps ONE blackholed
    worker from stalling the whole control tick: the poll's sleep is
    clipped to the earliest outstanding deadline.

    ``timeout`` bounds the wait for NEW data only: once a frame has
    started arriving, its remaining bytes are read with a blocking
    recv (peers are trusted engine servers that write whole frames via
    sendall — a peer that stalls mid-frame is treated as about to die,
    and its eventual reset surfaces as ``closed``).

    ``first_failure`` ends the wait at the first ``closed`` or ``hung``
    entry and resolves every entry still outstanding to ``closed``: the
    poll of one instance's ranks, whose live ranks wait in a collective
    for the dead one and would never reply. A poll with no failure is
    the same single wait."""
    results: List[Optional[tuple]] = [None] * len(pendings)

    def failed() -> bool:
        return first_failure and any(
            r is not None and r[0] in ("closed", "hung") for r in results)
    groups: Dict[int, list] = {}    # id(rpc) -> [rpc, [(idx, pending)]]
    for idx, p in enumerate(pendings):
        if isinstance(p, Pending):
            groups.setdefault(id(p._rpc), [p._rpc, []])[1].append((idx, p))
        else:  # synchronously-completed stand-in: resolve up front
            try:
                results[idx] = ("ok", p.wait())
            except RemoteError as e:
                results[idx] = ("error", e)
            except TransportClosed as e:
                results[idx] = ("closed", e)

    def settle(rpc, items):
        left = []
        for idx, p in items:
            if p.ready():
                try:
                    results[idx] = ("ok", rpc._take(p.call_id))
                except RemoteError as e:
                    results[idx] = ("error", e)
            else:
                left.append((idx, p))
        return left

    def pump_ready(rpc, items):
        """Settle cached replies, then keep consuming frames our own
        buffer already holds (select can't see those)."""
        items = settle(rpc, items)
        while items and rpc.conn.has_buffered():
            try:
                rpc._pump_one()
            except TransportClosed as e:
                for idx, _ in items:
                    results[idx] = ("closed", e)
                return []
            items = settle(rpc, items)
        return items

    def expire(now):
        """Resolve pendings whose per-call deadline has passed to
        ``hung`` — without disturbing the rest of their group."""
        for key in list(groups):
            rpc, items = groups[key]
            still = []
            for idx, p in items:
                if p.deadline is not None and now >= p.deadline:
                    results[idx] = ("hung", RpcTimeout(
                        f"call {p.call_id} "
                        f"({rpc.conn.peer_label or 'peer'}) missed its "
                        "deadline with the socket still open"))
                else:
                    still.append((idx, p))
            if len(still) != len(items):
                groups[key][1] = still
                if not still:
                    sel.unregister(rpc.conn)
                    del groups[key]

    def earliest_deadline():
        out = None
        for _, items in groups.values():
            for _, p in items:
                if p.deadline is not None:
                    out = p.deadline if out is None else min(out, p.deadline)
        return out

    sel = selectors.DefaultSelector()
    try:
        for key in list(groups):
            rpc, items = groups[key]
            items = pump_ready(rpc, items)
            if items:
                groups[key][1] = items
                sel.register(rpc.conn, selectors.EVENT_READ, groups[key])
            else:
                del groups[key]

        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while groups and not failed():
            now = time.monotonic()
            expire(now)
            if not groups or failed():
                break
            wake = deadline
            call_dl = earliest_deadline()
            if call_dl is not None:
                wake = call_dl if wake is None else min(wake, call_dl)
            budget = (None if wake is None
                      else max(0.0, wake - now))
            events = sel.select(budget)
            if not events:
                if deadline is not None and time.monotonic() >= deadline:
                    n = sum(len(g[1]) for g in groups.values())
                    raise TransportError(
                        f"drain_pendings timed out with {n} replies "
                        "outstanding")
                continue
            for ev_key, _ in events:
                group = ev_key.data
                rpc, items = group
                try:
                    rpc._pump_one()
                except TransportClosed as e:
                    for idx, _ in items:
                        results[idx] = ("closed", e)
                    items = []
                else:
                    items = pump_ready(rpc, items)
                group[1] = items
                if not items:
                    sel.unregister(rpc.conn)
                    del groups[id(rpc)]
    finally:
        sel.close()
    for idx, r in enumerate(results):
        if r is None:   # only after a failure under ``first_failure``
            results[idx] = ("closed", NotAwaited(
                "not awaited: another peer of this call failed"))
    return results  # type: ignore[return-value]


def serve(conn: Connection, dispatch: Dict[str, Callable],
          *, stop_op: str = "shutdown"):
    """Server side: dispatch loop until ``stop_op`` or peer hangup.

    Handler exceptions are caught and returned as error replies (the
    server survives an ``OutOfBlocks`` on import); transport errors end
    the loop — the parent is gone, so is our reason to exist."""
    while True:
        try:
            msg = conn.recv()
        except TransportClosed:
            return
        cid, op = msg.get("id"), msg.get("op")
        if op == stop_op:
            conn.send({"id": cid, "ok": True, "result": None})
            return
        fn = dispatch.get(op)
        try:
            if fn is None:
                raise KeyError(f"unknown op {op!r}")
            trace = msg.get("trace")
            if trace is not None and "_on_trace" in dispatch:
                # piggybacked trace context: hand it to the server
                # BEFORE the op runs, so e.g. a submit records spans
                # from its very first lifecycle hook
                dispatch["_on_trace"](trace)
            result = fn(*msg.get("args", ()), **msg.get("kw", {}))
            reply = {"id": cid, "ok": True, "result": result}
        except Exception as e:  # noqa: BLE001 - proxied to the caller
            reply = {"id": cid, "ok": False,
                     "kind": type(e).__name__, "error": str(e)}
        try:
            conn.send(reply)
        except TransportClosed:
            return


def _install_env_faults():
    """``REPRO_FAULTS=<plan.json>``: auto-install a serialized FaultPlan
    so chaos runs are reproducible from the environment alone (the CLI,
    the benchmarks, and CI all pick it up without code changes). Worker
    processes inherit the variable but hold only unlabeled connections,
    so the plan is inert in them."""
    path = os.environ.get("REPRO_FAULTS")
    if path:
        from repro_torch.serving import faults
        faults.install_from_file(path)


_install_env_faults()


def _np_roundtrip_selftest():  # pragma: no cover - debugging aid
    buf = io.BytesIO()
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    buf.write(encode({"a": a}))
    out = decode(buf.getvalue())
    assert (out["a"] == a).all()
