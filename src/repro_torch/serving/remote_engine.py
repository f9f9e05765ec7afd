"""Multi-process serving instances: a real paged ``Engine`` in a child
process behind an engine-server loop, driven through ``EngineProxy``.

Counterpart of ``repro.serving.remote_engine`` for the port. Topology
(one proxy <-> one server, one stream socket each)::

    orchestrator process                      engine-server process
    ────────────────────                      ─────────────────────
    EngineProxy ──frames──▶ transport.serve ──▶ Engine(cache_kind=paged)
       │  submit/step/apply_plan/pause/...          │ its own CUDA context,
       ◀── step reply: finished Requests,  ◀────────┘ pool and CUDA graphs
           serialized EngineTelemetry, gauge dict

The child is SPAWNED (never forked: a CUDA context does not survive a
fork), connects back to the parent's rendezvous socket (or listens at an
inventory endpoint), receives its init stream, builds the engine on the
device named in the engine kwargs (``"cuda"`` on the card, ``"cpu"`` in
tests), acks ready and enters the dispatch loop. Several servers on one
card each hold a CUDA context and time-slice the card.

**The init stream** (where the reference sends its whole parameter tree
in one frame): a header frame carries ``cfg``, the engine kwargs and the
tree's paths, shapes and dtypes, and then one frame per slice of a
tensor follows, each at most a quarter of the connection's receive bound
(``transport.DEFAULT_MAX_RECV_FRAME``): a whole tensor where it fits,
else whole leading-axis rows (the layer slices of a stacked ``[L, ...]``
weight), else flat element ranges. A full-width stacked MLP weight of
tinyllama-1.1b is 507 MB in bf16, past the 256 MB bound. bf16 travels
as raw ``np.uint16`` bits tagged ``"bfloat16"`` (numpy has no bf16),
like the migration ``"bits"`` wire. The child uploads each slice to its
device as it arrives and acks ready after the last one and the engine's
construction.

Everything after init is the reference's protocol, frame for frame:
admissions, telemetry, plans and the column-keyed block payloads of
``paged_kv.export_blocks``. A migration payload ships on the proxy's
``wire``: ``"bits"`` between port servers, ``"float32"`` where the
destination is a JAX peer, whose import converts by value.

**A draw in place of the stream**: the header may name ``draw``
(``{"seed", "dtype"}``) and carry no tensor frames. The server then
draws ``models.transformer.init_params(cfg, torch.Generator(device)
.manual_seed(seed), dtype)`` itself, as ``launch.serve`` does in its
own process; a stream at 0.2 GB/s over loopback would take minutes at
llama2-13b's 26 GB.

**A server in a replication group** (``serving.group.GroupInstance``):
the engine kwargs carry ``group``, a spec of the group's store
(``host:port`` of a ``TCPStore`` the orchestrator hosts), the prefix, W
and the rank and device of this server. The server sets its card, joins
the group (``core.replication.ReplicationGroup.build``: NCCL where each
rank has a card of its own, gloo on the CPU) and runs its first
collective before anything is captured; with a draw only rank 0 draws,
and ``replicate_params_for_plan`` broadcasts the tree to the others. It
then builds ``Engine(group=...)``. A server that fails to join raises;
none falls back to a group of one.

Three rendezvous modes share that contract (child dials back; child
listens at ``endpoint``; attach to a server already running, started
with ``python -m repro_torch.launch.pod --serve tcp://0.0.0.0:PORT``).

Liveness: the proxy keeps a ``pristine`` clone of every request the
server holds (``inflight_requests``); when the server dies the next RPC
raises ``TransportClosed`` and the orchestrator replays those clones on
a surviving instance, token-identically.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import gc
import multiprocessing as mp
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import replication as R
from repro_torch.kernels.paged_decode import (paged_decode_attention,
                                              paged_decode_attention_ref)
from repro_torch.models import layers as LY
from repro_torch.models import transformer as T
from repro_torch.serving import instrument as INS
from repro_torch.serving import observe as OBS
from repro_torch.serving import paged_kv as PK
from repro_torch.serving import transport as TR
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.graphs import launches_run
from repro_torch.serving.instance import InstanceHandle, pristine
from repro_torch.serving.instrument import EngineTelemetry
from repro_torch.serving.request import RequestSpec


# ============================================================ init stream
def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _slices(t: torch.Tensor, budget: int):
    """(offset, count) element ranges of flat ``t``, each at most
    ``budget`` bytes: whole leading-axis rows where a row fits."""
    n = t.numel()
    per = max(1, budget // t.element_size())
    row = n // t.shape[0] if t.dim() and t.shape[0] else n
    if 0 < row <= per:
        per -= per % row
    return [(off, min(per, n - off)) for off in range(0, n, per)]


def _host_flat(t: torch.Tensor) -> np.ndarray:
    """``t`` flattened on the host as the wire carries it (bf16 as its
    uint16 bits)."""
    flat = t.detach().reshape(-1).cpu()
    if flat.dtype == torch.bfloat16:
        return flat.view(torch.int16).numpy().view(np.uint16)
    return flat.numpy()


def _wire_dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def send_init(conn: "TR.Connection", cfg, params, engine_kw: dict,
              draw: Optional[dict] = None,
              server: Optional[dict] = None) -> int:
    """Send the init stream (module docstring) over ``conn``: the header,
    then every tensor of ``params`` in slices of at most a quarter of
    ``conn.max_frame`` bytes; or, with ``draw`` (``{"seed", "dtype"}``),
    the header alone. ``server`` holds ``EngineServer``'s options.
    Returns the weight bytes shipped."""
    budget = max(1, conn.max_frame // 4)
    leaves = [] if draw is not None else list(_leaves(params))
    plan = [(path, t, _slices(t, budget)) for path, t in leaves]
    conn.send({"cfg": cfg, "engine_kw": dict(engine_kw),
               "tensors": [[list(p), list(t.shape), _wire_dtype(t)]
                           for p, t, _ in plan],
               "frames": sum(len(s) for _, _, s in plan),
               "draw": dict(draw) if draw is not None else None,
               "server": dict(server or {})})
    nbytes = 0
    for path, t, slices in plan:
        host = _host_flat(t)
        for off, n in slices:
            conn.send({"path": list(path), "offset": off,
                       "dtype": _wire_dtype(t), "data": host[off:off + n]})
            nbytes += n * t.element_size()
    return nbytes


def server_device(engine_kw: dict) -> torch.device:
    """The device an engine server builds on: ``engine_kw["device"]``,
    CUDA when none is named. Raises when that is CUDA and this process
    has no card: a server never falls back to the CPU."""
    dev = torch.device(engine_kw.get("device") or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"engine server asked for {dev}, and this "
                           "process sees no CUDA device")
    return dev


def receive_weights(header: dict, frames) -> dict:
    """Rebuild the parameter tree of an init ``header`` on the server's
    device from its ``frames`` (an iterator of slice frames), uploading
    each slice as it arrives. Every element must arrive exactly once."""
    device = server_device(header["engine_kw"])
    flat, left = {}, {}
    for path, shape, dtype in header["tensors"]:
        t = torch.empty(shape, dtype=getattr(torch, dtype), device=device)
        flat[tuple(path)] = (t, t.view(torch.int16) if dtype == "bfloat16"
                             else t, dtype)
        left[tuple(path)] = t.numel()
    for f in frames:
        path = tuple(f["path"])
        if path not in flat:
            raise ValueError(f"weight frame for unknown tensor {path}")
        _, dst, dtype = flat[path]
        data, off = f["data"], int(f["offset"])
        if f["dtype"] != dtype or off < 0 or off + data.size > dst.numel():
            raise ValueError(f"weight frame {path} [{off}, +{data.size}) "
                             f"{f['dtype']} does not fit {dtype} "
                             f"{tuple(dst.shape)}")
        if dtype == "bfloat16":
            data = data.view(np.int16)
        dst.view(-1)[off:off + data.size].copy_(torch.from_numpy(data))
        left[path] -= data.size
    short = {p: n for p, n in left.items() if n}
    if short:
        raise ValueError(f"weight stream ended with elements missing: {short}")
    params: dict = {}
    for path, (t, _, _) in flat.items():
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _sync(device):
    INS.synchronize(torch.device(device))


def join_group(spec: dict):
    """Join the replication group of ``spec`` (module docstring): this
    process's card set first, the group built over a client of the
    orchestrator's store under the group's prefix, and its first
    collective run, before any graph is captured (NCCL forms the
    communicator there). Returns the group and that collective's
    seconds. Raises where a rank fails to join or the collective
    fails."""
    device = torch.device(spec["device"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"group rank {spec['rank']} asked for "
                               f"{device}, and this process sees no CUDA "
                               "device")
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=float(spec.get("timeout", 300)))
    host, port = spec["store"].rsplit(":", 1)
    store = dist.TCPStore(host, int(port), is_master=False, timeout=timeout)
    group = R.ReplicationGroup.build(dist.PrefixStore(spec["prefix"], store),
                                     int(spec["rank"]), int(spec["size"]),
                                     device, timeout)
    t0 = time.perf_counter()
    group.all_reduce(torch.zeros(1, device=device))
    _sync(device)
    return group, time.perf_counter() - t0


def advertise_store(engine_kw: dict, conn: "TR.Connection") -> dict:
    """``engine_kw`` with its group's store address completed: a spec
    whose store names no host (``":port"``, a group whose ranks are not
    all on loopback) gets the local address of ``conn``, the connection
    over which the orchestrator reached this rank's node, which that node
    can reach back."""
    spec = engine_kw.get("group")
    if spec is None or not spec["store"].startswith(":"):
        return engine_kw
    return dict(engine_kw, group=dict(
        spec, store=f"{conn.local_host()}{spec['store']}"))


def draw_weights(cfg, draw: dict, device, group=None) -> dict:
    """The parameter tree of ``draw`` (``{"seed", "dtype"}``) on
    ``device``: ``init_params`` from a generator seeded ``seed`` on this
    device, bit-equal to the same draw in any other process on the same
    card type. In a group only rank 0 draws; the other ranks allocate
    the tree and ``replicate_params_for_plan`` broadcasts rank 0's."""
    dtype = draw["dtype"]
    if group is None or group.rank == 0:
        gen = torch.Generator(device=device).manual_seed(int(draw["seed"]))
        return T.init_params(cfg, gen, dtype)
    return _tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device=device),
                     T.init_params_meta(cfg, dtype))


@contextlib.contextmanager
def checked_paged_calls(out: list):
    """Inside, every paged-decode call through ``models.layers`` is held
    against ``paged_decode_attention_ref`` on the same inputs: ``out``
    collects each call's relative L2 distance."""
    paged = LY.paged_decode_attention

    def checked(q, k_pool, v_pool, tables, lengths):
        o = paged(q, k_pool, v_pool, tables, lengths)
        ref = paged_decode_attention_ref(q, k_pool, v_pool, tables, lengths)
        d = (o.float() - ref.float()).norm() / ref.float().norm().clamp_min(
            1e-30)
        out.append(float(d))
        return o

    LY.paged_decode_attention = checked
    try:
        yield out
    finally:
        LY.paged_decode_attention = paged


# ============================================================ server side
class EngineServer:
    """Dispatch table around one Engine (runs in the child process).

    Beside the reference's gauges, ``info`` carries what a card run
    gates on: the server's device, the paged kernel's launches
    (``graphs.launches_run``), graph captures, replays and eager steps,
    decode steps and keys, per steady step (no queue, nothing
    prefilling, no capture) its host syncs and host-clock milliseconds,
    and the server's bring-up seconds. Every step reply carries the
    step's record (``log``): whether it decoded, the degrees it ran
    under, its all-gathers and host syncs, whether it was steady or
    captured.

    Options (the init header's ``server``): ``sync_debug`` runs each
    steady step on the card under ``torch.cuda.set_sync_debug_mode(
    "error")``; ``check_paged`` runs the first steady step whose degrees
    replicate eagerly with every paged call held against its plain
    version (``paged_checks``; that step is counted apart, under
    ``checked_steps``). Every import (``resume_request``,
    ``prepare_resume``, ``commit_resume``) is read back from the pool
    and held bit for bit against its payload (``paged_kv.read_back``)."""

    def __init__(self, engine, *, sync_debug: bool = False,
                 check_paged: bool = False,
                 bringup: Optional[dict] = None):
        self.engine = engine
        self.telemetry = EngineTelemetry()
        self.recorder = None   # lazy observe.EngineSpanRecorder
        self.steady_syncs: collections.Counter = collections.Counter()
        self.steady_ms: collections.deque = collections.deque(maxlen=512)
        dev = engine.device
        self.device_name = (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")
        self.sync_debug = bool(sync_debug) and dev.type == "cuda"
        self.check_paged = bool(check_paged)
        self.paged_checks: List[float] = []
        self.checked_steps = 0
        self.bringup = dict(bringup or {})

    # ---- serving ops
    def submit(self, spec: RequestSpec):
        self.engine.submit(spec)
        return len(self.engine.queue)

    def set_token_budget(self, budget: int) -> int:
        return self.engine.set_token_budget(int(budget))

    def step(self):
        e = self.engine
        steady = bool(e.active) and not e.queue and not e.prefilling
        degrees = getattr(e, "_step_degrees", None)
        replicated = degrees is not None and max(degrees) > 1
        check = (self.check_paged and not self.paged_checks and steady
                 and replicated)
        captures = sum(e.graphs.counts.captures.values())
        decoded = e._step_count
        strict = self.sync_debug and steady and not check
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            n = stack.enter_context(R.count_collectives(e.group))
            syncs = stack.enter_context(INS.count_host_syncs())
            if check:
                # the checked step runs eagerly: a replay calls no wrapper
                stack.enter_context(checked_paged_calls(self.paged_checks))
                stack.callback(setattr, e.graphs, "enabled",
                               e.graphs.enabled)
                e.graphs.enabled = False
            if strict:
                torch.cuda.set_sync_debug_mode("error")
                stack.callback(torch.cuda.set_sync_debug_mode, 0)
            done = INS.timed_step(e, self.telemetry)
        ms = (time.perf_counter() - t0) * 1e3
        captured = sum(e.graphs.counts.captures.values()) != captures
        self.checked_steps += int(check)
        if steady and not captured and not check:
            self.steady_syncs[str(syncs.n)] += 1
            self.steady_ms.append(ms)
        log = {"decode": e._step_count > decoded,
               "degrees": list(degrees) if replicated else None,
               "gathers": n.get("all-gather", 0), "syncs": syncs.n,
               "steady": steady, "captured": captured, "checked": check,
               "ms": ms}
        out = {"finished": done, "telemetry": self.telemetry.to_state(),
               "info": self.info(), "log": log,
               # full per-stream token lists each step: the ingress
               # streaming feed rides the reply, no extra RPC
               "streams": {int(r): list(t) for r, t
                           in e.stream_progress().items()}}
        if self.recorder is not None:
            out["spans"] = self.recorder.drain()
        return out

    # ---- tracing
    def _on_trace(self, ctx: dict):
        """Trace context piggybacked on an RPC frame: install the span
        recorder on first use, register rid -> trace id."""
        if self.recorder is None:
            self.recorder = OBS.EngineSpanRecorder(
                origin=f"server:{os.getpid()}")
            self.engine.span_hook = self.recorder
        self.recorder.register(int(ctx["rid"]), ctx["trace_id"])

    def trace_register(self, ctx: dict):
        self._on_trace(ctx)
        return True

    def clock_sync(self) -> float:
        return OBS.server_now()

    def apply_plan(self, p: List[int]):
        self.engine.apply_plan(list(p))
        return True

    def requeue_front(self, req: Request):
        self.engine.queue.appendleft(req)
        return len(self.engine.queue)

    def push_queue(self, req: Request):
        self.engine.queue.append(req)
        return len(self.engine.queue)

    def drain_queue(self):
        out = []
        while self.engine.queue:
            out.append(self.engine.queue.popleft())
        return out

    # ---- telemetry
    def info(self) -> dict:
        e = self.engine
        ms = sorted(self.steady_ms)
        return {"clock": e.clock,
                "queue_len": len(e.queue),
                "active": {int(s): int(r) for s, r in e.slot_rids().items()},
                "free_blocks": e.pstate.free_block_count(),
                "blocks_in_use": e.pstate.blocks_in_use(),
                "n_blocks": e.pstate.n_blocks,
                "max_batch": e.max_batch,
                "pool_bytes": e.pstate.pool_bytes(),
                "preempt_count": e.preempt_count,
                "prefix_stats": e.prefix_stats(),
                "block_size": e.block_size,
                "prefix_keys": sorted(e.prefix_keys()),
                "pid": os.getpid(),
                "device": str(e.device),
                "device_name": self.device_name,
                "decode_steps": e._step_count,
                "paged_launches": launches_run(paged_decode_attention,
                                               [e.graphs]),
                "graph_captures": dict(e.graphs.counts.captures),
                "graph_replays": dict(e.graphs.counts.replays),
                "graph_eager": dict(e.graphs.counts.eager),
                "decode_keys": len({k for k in e.graphs.keys
                                    if k[0] == "decode"}),
                "checked_steps": self.checked_steps,
                "paged_checks": list(self.paged_checks),
                "bringup": self.bringup,
                "peak_bytes": (torch.cuda.max_memory_allocated(e.device)
                               if e.device.type == "cuda" else 0),
                "steady_syncs": dict(self.steady_syncs),
                "steady_ms": ([ms[len(ms) // 2], ms[0], ms[-1], len(ms)]
                              if ms else [])}

    def pool_checksum(self) -> list:
        """The pool's bits (``paged_kv.pool_checksum``): equal on every
        rank of a group whose pools are replicas."""
        return PK.pool_checksum(self.engine.pstate)

    def params_checksum(self) -> list:
        """``instrument.bits_checksum`` of every weight, in the tree's
        order: equal on every rank of a group, and equal to the same
        draw's anywhere."""
        return [INS.bits_checksum(t) for _, t in _leaves(self.engine.params)]

    def witness_top2(self, tokens) -> list:
        """The top-2 logits and ids after ``tokens`` (one sequence, a
        cache-less forward of the engine's weights): the witness of a
        greedy tie between two runs."""
        e = self.engine
        x = torch.as_tensor(np.asarray(tokens, np.int64)[None],
                            device=e.device)
        with torch.no_grad():
            logits, _, _ = T.forward(e.params, e.cfg, x, mode="train")
        vals, ids = logits[0, -1, :e.cfg.vocab_size].float().topk(2)
        return [vals.cpu().tolist(), ids.cpu().tolist()]

    # ---- migration (each blocks until device state is real: the reply
    # frame doubles as the transfer-complete barrier, and piggybacks the
    # gauge dict)
    def _sync(self):
        INS.synchronize(self.engine.device)

    def _reply(self, result):
        out = {"result": result, "info": self.info()}
        if self.recorder is not None:
            spans = self.recorder.drain()
            if spans:
                out["spans"] = spans
        return out

    def _read_back(self, out: dict, slot, kv: dict):
        """Hold the blocks an import wrote into ``slot`` against the
        payload ``kv`` (``paged_kv.read_back``); the reply carries their
        digest."""
        if slot is not None:
            out["read_back"] = PK.read_back(self.engine.pstate, slot, kv)
        return out

    def pause_request(self, slot: int, since_epoch=None, wire: str = "bits"):
        payload = self.engine.pause_request(slot, since_epoch=since_epoch,
                                            wire=wire)
        return self._reply(payload)

    def resume_request(self, payload: dict):
        ok = self.engine.resume_request(payload)
        self._sync()
        slot = (payload["request"].slot if ok else None)
        return self._read_back(self._reply(ok), slot, payload["kv"])

    def snapshot_request(self, slot: int, wire: str = "bits"):
        return self.engine.snapshot_request(slot, wire=wire)

    def prepare_resume(self, snap: dict):
        slot = self.engine.prepare_resume(snap)
        self._sync()
        return self._read_back(self._reply(slot), slot, snap["kv"])

    def commit_resume(self, slot: int, payload: dict):
        ok = self.engine.commit_resume(slot, payload)
        self._sync()
        return self._read_back(self._reply(ok), slot if ok else None,
                               payload["kv"])

    def abort_resume(self, slot: int):
        self.engine.abort_resume(slot)
        return self._reply(True)

    # ---- liveness
    def ping(self):
        return "pong"

    def heartbeat(self):
        """The hung-vs-dead probe payload: cheap, never touches the
        device."""
        return {"clock": self.engine.clock,
                "queue_len": len(self.engine.queue),
                "pid": os.getpid()}

    def crash(self):
        """Test-only fault injection: die without a word."""
        os._exit(17)

    def dispatch(self) -> dict:
        d = {op: getattr(self, op) for op in (
            "submit", "set_token_budget", "step", "apply_plan",
            "requeue_front", "push_queue",
            "drain_queue", "info", "pause_request", "resume_request",
            "snapshot_request", "prepare_resume", "commit_resume",
            "abort_resume", "ping", "heartbeat", "crash",
            "trace_register", "clock_sync", "pool_checksum",
            "params_checksum", "witness_top2")}
        # not a wire op: transport.serve's hook for trace contexts
        d["_on_trace"] = self._on_trace
        return d


def _serve_connection(conn: "TR.Connection"):
    """Shared tail of both server entries: build the engine from the
    init stream, ack ready (or answer the failure, after reading the
    stream out), serve until shutdown/hangup."""
    header = conn.recv()
    frames = (conn.recv() for _ in range(int(header["frames"])))
    try:
        kw = dict(header["engine_kw"])
        spec = kw.pop("group", None)
        bringup, group, t0 = {}, None, time.perf_counter()
        if spec is not None:
            group, bringup["first_collective_s"] = join_group(spec)
            kw["device"] = group.device
            bringup["group_s"] = time.perf_counter() - t0
        if header.get("draw") is not None:
            device = server_device(kw)
            t0 = time.perf_counter()
            params = draw_weights(header["cfg"], header["draw"], device,
                                  group)
            _sync(device)
            bringup["draw_s"] = time.perf_counter() - t0
            if group is not None:
                t0 = time.perf_counter()
                R.replicate_params_for_plan(params, group)
                _sync(device)
                bringup["broadcast_s"] = time.perf_counter() - t0
        else:
            params = receive_weights(dict(header, engine_kw=kw), frames)
        engine = Engine(header["cfg"], params, group=group, **kw)
        server = EngineServer(engine, bringup=bringup,
                              **header.get("server", {}))
    except Exception as e:
        for _ in frames:   # the proxy is still streaming: read it out
            pass
        conn.send({"id": 0, "ok": False, "kind": type(e).__name__,
                   "error": str(e)})
        conn.close()
        raise
    conn.send({"id": 0, "ok": True, "result": "ready"})
    TR.serve(conn, server.dispatch())
    conn.close()
    # the engine's graphs go before its group: NCCL's abort of a
    # communicator that a live graph's collectives hold hangs at exit
    del server, engine, params
    gc.collect()
    if group is not None:
        _sync(group.device)


def engine_server_main(address: str):
    """Child-process entry, dial-back mode: connect to the parent's
    rendezvous listener (AF_UNIX path or ``tcp://host:port``), then
    serve."""
    _serve_connection(TR.connect(address))


def engine_server_listen(address: str):
    """Engine-server entry, listening mode: bind ``address``, accept ONE
    orchestrator, serve it, exit. Run standalone on a pod node via
    ``python -m repro_torch.launch.pod --serve tcp://0.0.0.0:PORT``."""
    srv = TR.listen(address)
    try:
        conn = TR.accept(srv, timeout=None)
    finally:
        srv.close()
    _serve_connection(conn)


# ============================================================= proxy side
class _PendingStage:
    """Pipelined prepare_resume: unwraps the piggybacked gauge dict on
    completion and maps a dead peer to TransportClosed."""

    def __init__(self, proxy: "EngineProxy", pending: TR.Pending):
        self._proxy = proxy
        self._pending = pending

    def wait(self):
        try:
            return self._proxy._unwrap(self._pending.wait())
        except TR.TransportClosed:
            self._proxy._dead = True
            raise


def rendezvous_transport() -> str:
    """Transport family for spawned proxies with no explicit endpoint:
    ``REPRO_RPC_TRANSPORT=tcp`` lifts the plane onto loopback TCP,
    anything else keeps the AF_UNIX default."""
    return os.environ.get("REPRO_RPC_TRANSPORT", "unix").lower()


class EngineProxy(InstanceHandle):
    """The orchestrator-side handle of a remote engine: mirrors the
    in-process ``Engine`` control surface over RPC frames. Gauges read a
    cache refreshed by every step reply; the step reply is drained
    through the orchestrator's batched poll (``step_async`` +
    ``finish_step``).

    ``engine_kw`` goes to the server's ``Engine`` (``device`` among
    them: without it the server builds on CUDA or raises). ``wire`` is
    the migration wire this proxy's exports ship on (``"bits"`` for a
    port peer, ``"float32"`` for a JAX peer). ``draw`` (``{"seed",
    "dtype"}``) has the server draw its weights in place of ``params``'
    stream; ``server`` holds ``EngineServer``'s options. ``bringup``
    holds the connect, weight-stream and ready seconds and the weight
    bytes."""

    def __init__(self, cfg, params, *, start_timeout: float = 120.0,
                 endpoint: Optional[str] = None, spawn: bool = True,
                 adopt_process=None, peer_label: Optional[str] = None,
                 wire: str = "bits", draw: Optional[dict] = None,
                 server: Optional[dict] = None, **engine_kw):
        self.telemetry = EngineTelemetry()
        self._inflight: Dict[int, Request] = {}   # rid -> pristine clone
        self._streams: Dict[int, List[int]] = {}  # last step's stream feed
        self._span_feed: List[dict] = []   # skew-corrected server spans
        self.clock_offset = 0.0            # server clock - ours (est.)
        self._dead = False
        self.process = None
        self.endpoint = endpoint
        self.peer_label = peer_label
        self.wire = wire
        self.bringup: Dict[str, float] = {}
        # everything respawn() needs to bring up a fresh replacement
        self._spec = {"cfg": cfg, "params": params,
                      "start_timeout": start_timeout, "draw": draw,
                      "server": server, "engine_kw": dict(engine_kw)}
        self._listen_mode = endpoint is not None
        # a group's rank cannot rejoin its group alone
        self._respawnable = "group" not in engine_kw and (
            endpoint is None or spawn or adopt_process is not None)
        self._generation = 0
        try:
            self._start(cfg, params, start_timeout, endpoint, spawn,
                        adopt_process, engine_kw)
        except BaseException:
            # never leak a spawned engine server: a failed rendezvous /
            # init handshake reaps the child before propagating
            if self.process is not None and self.process.is_alive():
                self.process.kill()
                self.process.join(timeout=10)
            raise

    def _start(self, cfg, params, start_timeout, endpoint, spawn,
               adopt_process, engine_kw):
        ctx = mp.get_context("spawn")     # CUDA does not survive a fork
        t0 = time.perf_counter()
        if endpoint is None:
            # dial-back rendezvous: parent listens, spawned child connects
            if rendezvous_transport() == "tcp":
                srv = TR.listen("tcp://127.0.0.1:0")
                address = TR.bound_endpoint(srv)
            else:
                address = TR.listener_address()
                srv = TR.listen(address)
            self.endpoint = address
            self.process = ctx.Process(target=engine_server_main,
                                       args=(address,), daemon=True)
            self.process.start()
            try:
                self.conn = TR.accept(srv, timeout=start_timeout)
            finally:
                srv.close()
                if TR.parse_endpoint(address)[0] == "unix":
                    try:
                        os.unlink(address)
                    except OSError:
                        pass
        else:
            if spawn:
                self.process = ctx.Process(target=engine_server_listen,
                                           args=(endpoint,), daemon=True)
                self.process.start()
            elif adopt_process is not None:
                self.process = adopt_process

            def child_died() -> Optional[str]:
                # a spawned server that died before binding would
                # otherwise look like "still booting" until the deadline
                if self.process is not None and not self.process.is_alive():
                    return (f"engine server exited with code "
                            f"{self.process.exitcode} before accepting")
                return None

            self.conn = TR.connect(endpoint, timeout=start_timeout,
                                   abort=child_died)
        self.conn.peer_label = self.peer_label
        self.rpc = TR.Rpc(self.conn)
        t1 = time.perf_counter()
        nbytes = send_init(self.conn, cfg, params,
                           advertise_store(dict(engine_kw, cache_kind="paged"),
                                           self.conn),
                           draw=self._spec["draw"],
                           server=self._spec["server"])
        t2 = time.perf_counter()
        ready = self.conn.recv()          # init ack doubles as ready gate
        if not ready.get("ok"):
            raise TR.RemoteError(ready.get("kind", "Error"),
                                 ready.get("error", repr(ready)))
        if ready.get("result") != "ready":
            raise TR.TransportError(f"engine server init reply {ready!r}")
        self.bringup = {"connect_s": t1 - t0, "weights_s": t2 - t1,
                        "weight_bytes": nbytes,
                        "ready_s": time.perf_counter() - t2}
        self._info = self._call("info")
        self.clock_offset = OBS.estimate_clock_offset(
            lambda: self._call("clock_sync"))

    # ------------------------------------------------------------- rpc
    def _call(self, op, *args, **kw):
        if self._dead:
            raise TR.TransportClosed(f"instance already dead ({op})")
        try:
            return self.rpc.call(op, *args, **kw)
        except TR.TransportClosed:
            self._dead = True
            raise

    # ------------------------------------------------------ serving ops
    def submit(self, spec: RequestSpec, trace: Optional[dict] = None):
        # the mirror holds the minted-but-never-run Request: pristine by
        # construction, replayable token-identically after a crash
        self._inflight[spec.rid] = spec.to_request()
        self._info["queue_len"] = self._call("submit", spec, _trace=trace)

    def set_token_budget(self, budget: int) -> int:
        return int(self._call("set_token_budget", int(budget)))

    def step(self) -> List[Request]:
        return self.finish_step(self._call("step"))

    def step_async(self) -> TR.Pending:
        """Fan-out half of the batched control-plane poll: send the step
        request without waiting."""
        if self._dead:
            raise TR.TransportClosed("instance already dead (step)")
        try:
            return self.rpc.call_async("step")
        except TR.TransportClosed:
            self._dead = True
            raise

    def finish_step(self, reply: dict) -> List[Request]:
        """Apply one step reply: refresh the telemetry mirror and gauge
        cache, retire finished requests from the inflight mirror."""
        self.telemetry.load_state(reply["telemetry"])
        self._info = reply["info"]
        self._streams = {int(r): list(t) for r, t
                         in reply.get("streams", {}).items()}
        spans = reply.get("spans")
        if spans:
            self._span_feed.extend(
                OBS.correct_spans(spans, self.clock_offset))
        done = reply["finished"]
        for r in done:
            self._inflight.pop(r.rid, None)
        return done

    # ---------------------------------------------------------- tracing
    def register_trace(self, ctx: dict):
        self._call("trace_register", ctx)

    def drain_spans(self) -> List[dict]:
        if not self._span_feed:
            return []
        out, self._span_feed = self._span_feed, []
        return out

    def apply_plan(self, p):
        p = list(p.p) if hasattr(p, "p") else list(p)
        self._call("apply_plan", p)

    def requeue_front(self, req: Request):
        self._inflight[req.rid] = pristine(req)
        self._info["queue_len"] = self._call("requeue_front", req)

    def push_queue(self, req: Request):
        self._inflight[req.rid] = pristine(req)
        self._info["queue_len"] = self._call("push_queue", req)

    def drain_queue(self) -> List[Request]:
        out = self._call("drain_queue")
        for r in out:
            self._inflight.pop(r.rid, None)
        self._info["queue_len"] = 0
        return out

    # -------------------------------------------------------- telemetry
    def refresh_info(self):
        self._info = self._call("info")

    def info(self) -> dict:
        """The server's last gauge dict (``EngineServer.info``)."""
        return self._info

    def queue_len(self) -> int:
        return self._info["queue_len"]

    def active_rids(self) -> Dict[int, int]:
        return {int(s): rid for s, rid in self._info["active"].items()}

    def free_blocks(self) -> int:
        return self._info["free_blocks"]

    def blocks_in_use(self) -> int:
        return self._info["blocks_in_use"]

    @property
    def n_blocks(self) -> int:
        return self._info["n_blocks"]

    @property
    def max_batch(self) -> int:
        return self._info["max_batch"]

    def pool_bytes(self) -> int:
        return self._info["pool_bytes"]

    def clock(self) -> float:
        return self._info["clock"]

    def preempt_count(self) -> int:
        return self._info["preempt_count"]

    def prefix_stats(self) -> dict:
        return self._info["prefix_stats"]

    @property
    def block_size(self) -> int:
        return self._info.get("block_size", 0)

    def prefix_keys(self) -> set:
        return set(self._info.get("prefix_keys", ()))

    def stream_view(self) -> Dict[int, List[int]]:
        return self._streams

    # -------------------------------------------------------- migration
    def _unwrap(self, reply: dict):
        """Migration replies piggyback the server's gauge dict (and any
        spans the op closed)."""
        self._info = reply["info"]
        spans = reply.get("spans")
        if spans:
            self._span_feed.extend(
                OBS.correct_spans(spans, self.clock_offset))
        return reply["result"]

    def pause_request(self, slot: int,
                      since_epoch: Optional[int] = None) -> dict:
        payload = self._unwrap(self._call("pause_request", slot,
                                          since_epoch=since_epoch,
                                          wire=self.wire))
        self._inflight.pop(payload["request"].rid, None)
        return payload

    def resume_request(self, payload: dict) -> bool:
        ok = self._unwrap(self._call("resume_request", payload))
        if ok:
            self._inflight[payload["request"].rid] = \
                pristine(payload["request"])
        return ok

    def snapshot_request(self, slot: int) -> dict:
        return self._call("snapshot_request", slot, wire=self.wire)

    def prepare_resume_async(self, snap: dict) -> "_PendingStage":
        if self._dead:
            raise TR.TransportClosed("instance already dead "
                                     "(prepare_resume)")
        return _PendingStage(self, self.rpc.call_async("prepare_resume",
                                                       snap))

    def commit_resume(self, slot: int, payload: dict) -> bool:
        ok = self._unwrap(self._call("commit_resume", slot, payload))
        if ok:
            self._inflight[payload["request"].rid] = \
                pristine(payload["request"])
        return ok

    def abort_resume(self, slot: int):
        self._unwrap(self._call("abort_resume", slot))

    # --------------------------------------------------------- liveness
    def set_rpc_deadline(self, seconds: Optional[float]):
        """Stamp a per-call deadline on every future RPC (None
        disables)."""
        self.rpc.call_timeout = seconds

    def probe(self, timeout: float = 1.0) -> str:
        """Classify this peer after a missed deadline: ``"dead"``
        (process exited or transport closed), ``"alive"`` (heartbeat
        answered within ``timeout``) or ``"hung"`` (socket open,
        heartbeat unanswered)."""
        if self._dead:
            return "dead"
        if self.process is not None and not self.process.is_alive():
            self._dead = True
            return "dead"
        try:
            self.rpc.call_timed("heartbeat", timeout)
            return "alive"
        except TR.RpcTimeout:
            return "hung"
        except TR.TransportClosed:
            self._dead = True
            return "dead"

    def quarantine(self):
        """Take a hung peer out of the plane for good: close the
        transport and hard-kill an owned process. Idempotent."""
        self._dead = True
        self.conn.close()
        if self.process is not None and self.process.is_alive():
            self.process.kill()
            self.process.join(timeout=10)

    @property
    def respawnable(self) -> bool:
        return self._respawnable

    def respawn(self, start_timeout: Optional[float] = None
                ) -> "EngineProxy":
        """Bring up a FRESH engine server from this proxy's init spec.
        Listening servers respawn at the same endpoint; dial-back
        children get a new rendezvous. The replacement starts empty and
        carries an incarnation-suffixed peer label (``w1`` ->
        ``w1~r1``)."""
        if not self._respawnable:
            raise RuntimeError(
                f"instance at {self.endpoint!r} is attach-only: its "
                "server is not ours to restart")
        spec = self._spec
        base = (self.peer_label.split("~", 1)[0]
                if self.peer_label else None)
        label = f"{base}~r{self._generation + 1}" if base else None
        fresh = EngineProxy(
            spec["cfg"], spec["params"],
            start_timeout=(spec["start_timeout"] if start_timeout is None
                           else start_timeout),
            endpoint=self.endpoint if self._listen_mode else None,
            spawn=True, peer_label=label, wire=self.wire,
            draw=spec["draw"], server=spec["server"], **spec["engine_kw"])
        fresh._generation = self._generation + 1
        fresh.set_rpc_deadline(self.rpc.call_timeout)
        return fresh

    def alive(self) -> bool:
        if self._dead:
            return False
        return self.process is None or self.process.is_alive()

    def mark_dead(self):
        """Record a transport death observed outside ``_call``."""
        self._dead = True

    def inflight_requests(self) -> List[Request]:
        return list(self._inflight.values())

    def kill(self):
        """Hard-kill the server: SIGKILL for a spawned child, abrupt
        socket close for an attached one."""
        if self.process is not None:
            self.process.kill()
            self.process.join(timeout=10)
        else:
            self.conn.close()
            self._dead = True

    def inject_crash(self):
        """Ask the server to os._exit mid-protocol (fault injection)."""
        try:
            self.rpc.call_async("crash")    # no reply will ever come
        except TR.TransportClosed:
            pass
        if self.process is not None:
            self.process.join(timeout=10)

    def close(self):
        if not self._dead and (self.process is None
                               or self.process.is_alive()):
            try:
                self.rpc.call("shutdown")
            except TR.TransportError:
                pass
        self._dead = True
        if self.process is not None:
            # a CUDA child tears its context down before it exits
            self.process.join(timeout=30)
            if self.process.is_alive():   # pragma: no cover - stuck child
                self.process.terminate()
                self.process.join(timeout=5)
        self.rpc.close()
