"""GroupInstance — one serving instance over W cards of a host.

The reference's engine replicates layers over a mesh of every local
device (``default_replication_mesh``: the largest power-of-two prefix of
the host's devices), so its Orchestrator and ``launch.serve`` scale a
plan's layers across every chip of the host. The port's ``Engine`` runs
one rank of such a group (``Engine(group=...)``, every rank running the
same calls); this module puts W of them behind one ``InstanceHandle``,
so the same Orchestrator drives an instance that spans W cards::

    orchestrator process              engine-server processes, a card each
    ────────────────────              ────────────────────────────────────
    GroupInstance ──EngineProxy──▶ rank 0: Engine(group=G) on cuda:0
        │  (TCPStore host)  ──▶ rank 1: Engine(group=G) on cuda:1  ◀─NCCL─▶
        │                   ──▶ ...
        └───────────────────▶ rank W-1: Engine(group=G) on cuda:W-1

* **Bring-up**: the handle hosts a ``TCPStore`` and starts its W
  ``EngineProxy``s together (each server joins the group at once,
  ``remote_engine.join_group``); weights come by seed (``draw``: rank 0
  draws, a broadcast replicates) or as the init stream to every rank.
* **Fan-out**: every call that changes engine state goes to all W ranks
  in the same order, each issued before any reply is awaited (a step's
  collectives block until every rank has joined): ``submit``, ``step``,
  ``apply_plan``, the queue surgery, the token budget, trace
  registration and every migration call.
* **Agreement**: the replies must agree — a step's finished ``(rid,
  generated)``, every stream's tokens, the engine clock and the degrees
  the step ran under; a migration payload's block bits; an import's
  slot and the digest of its blocks read back from each rank's pool
  (``paged_kv.read_back``). The ranks' pools are held bit-equal
  (``paged_kv.pool_checksum``) after every plan and every migration
  call. A disagreement raises ``GroupMismatch`` naming the
  rank and the rid.
* **Reads**: gauges, telemetry and the stream feed are rank 0's.
* **Failure**: a rank whose RPC finds its connection closed or misses
  its deadline fails the whole instance — the other ranks would wait in
  a collective forever — so the handle severs every rank (killing the
  processes it owns) and ``alive()`` turns false. The first such rank
  ends the wait for the others' replies at once: a rank that dies
  inside a step leaves its peers in that step's collective, and they
  never reply. The Orchestrator then replays the instance's in-flight
  streams from the handle's pristine mirror on another instance, token
  for token, as for one dead server. An instance never drops to fewer
  ranks.
* **Respawn**: a handle that spawned its servers (or was given a
  ``launcher`` of fresh endpoints) is ``respawnable``: ``respawn``
  joins the dead group's processes and brings up a fresh instance on
  the same cards with the same weights, over a new store and group, as
  ``EngineProxy.respawn`` does for one server. One that attached to
  servers it does not own is not.
"""
from __future__ import annotations

import datetime
import hashlib
import ipaddress
import itertools
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.serving import transport as TR
from repro_torch.serving.instance import InstanceHandle, pristine
from repro_torch.serving.remote_engine import EngineProxy
from repro_torch.serving.request import RequestSpec

_GROUPS = itertools.count()
#: seconds a server may take to come up, and a rank to join its group
START_TIMEOUT, GROUP_TIMEOUT = 300.0, 120.0


def is_loopback(endpoint: str) -> bool:
    """Whether ``endpoint`` is reached over this host's loopback: an
    AF_UNIX path, or a ``tcp://`` host that resolves to a loopback
    address."""
    kind, target = TR.parse_endpoint(endpoint)
    if kind != "tcp":
        return True
    try:
        return ipaddress.ip_address(socket.gethostbyname(target[0])).is_loopback
    except (OSError, ValueError):
        return False


def start_all(makers: List[Callable[[], "GroupInstance"]]) -> list:
    """Bring up one instance a maker, all at once (each spawn and group
    waits on its slowest rank, not on the other instances); when one
    fails, close the ones that came up and raise its error."""
    out: list = [None] * len(makers)
    errors: list = []

    def up(i):
        try:
            out[i] = makers[i]()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append((i, e))

    threads = [threading.Thread(target=up, args=(i,), daemon=True)
               for i in range(len(makers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for h in out:
            if h is not None:
                h.close()
        raise min(errors, key=lambda x: x[0])[1]
    return out


def host_width(device, count: int) -> int:
    """The cards one serving instance spans on this host: the largest
    power of two not above ``count`` visible cards when ``device`` is
    CUDA (the reference's ``default_replication_mesh``), else 1."""
    if torch.device(device).type != "cuda" or count < 1:
        return 1
    w = 1
    while w * 2 <= count:
        w *= 2
    return w


class GroupMismatch(RuntimeError):
    """The ranks of one instance answered one call differently."""


def kv_digest(kv: dict) -> str:
    """sha256 of a migration payload's columns, length and block bits."""
    h = hashlib.sha256()
    h.update(np.asarray(kv["cols"], np.int64).tobytes())
    h.update(str(int(kv["length"])).encode())
    for name in ("k", "v"):
        h.update(np.ascontiguousarray(kv[name]).tobytes())
    return h.hexdigest()


class _GroupWait:
    """A fanned-out call in flight: ``wait`` gathers every rank's reply
    and hands them to ``finish``."""

    def __init__(self, group: "GroupInstance", op: str, pendings, finish):
        self.group, self.op = group, op
        self.pendings, self.finish = pendings, finish

    def wait(self):
        return self.finish(self.group._gather(self.op, self.pendings))


class GroupInstance(InstanceHandle):
    """One serving instance over ``width`` engine servers that form one
    replication group (module docstring).

    ``params`` streams to every rank, or ``draw`` (``{"seed",
    "dtype"}``) has rank 0 draw and broadcast. Rank r runs on ``cuda:r``
    when ``engine_kw["device"]`` is CUDA, else on the CPU. The servers
    are spawned (dial-back children) unless ``endpoints`` names one per
    rank: then ``spawn`` starts a listening server at each (an inventory
    node of this host), else the handle attaches to servers already
    listening there. ``launcher`` (a callable returning ``width`` fresh
    endpoints to attach to) stands in for spawning, at bring-up and at
    every respawn. ``server`` holds each ``EngineServer``'s options;
    ``group_timeout`` bounds a rank's wait in the group's collectives.
    ``bringup`` keeps each rank's proxy and server bring-up seconds.

    The group's store listens on every interface (``TCPStore``'s
    server); ranks reached over loopback are told ``127.0.0.1``, others
    the local address of the connection over which this handle reached
    them (``remote_engine.advertise_store``)."""

    def __init__(self, cfg, params=None, *, width: int,
                 draw: Optional[dict] = None,
                 endpoints: Optional[List[str]] = None, spawn: bool = False,
                 launcher: Optional[Callable[[], List[str]]] = None,
                 server: Optional[dict] = None,
                 label: Optional[str] = None,
                 start_timeout: float = START_TIMEOUT,
                 group_timeout: float = GROUP_TIMEOUT, **engine_kw):
        if width < 1 or width & (width - 1):
            raise ValueError(f"a group instance needs a power-of-two "
                             f"width, got {width}")
        if (params is None) == (draw is None):
            raise ValueError("give the weights as params or as a draw")
        if launcher is not None:
            endpoints, spawn = launcher(), False
        if endpoints is not None and len(endpoints) != width:
            raise ValueError(f"{width} ranks need {width} endpoints")
        cuda = torch.device(engine_kw.get("device") or "cuda").type == "cuda"
        devices = [f"cuda:{r}" if cuda else "cpu" for r in range(width)]
        self.width = width
        self.label = label or f"group{next(_GROUPS)}"
        # everything respawn() needs to bring up a fresh replacement
        self._spec = dict(cfg=cfg, params=params, width=width, draw=draw,
                          endpoints=None if launcher else endpoints,
                          spawn=spawn, launcher=launcher, server=server,
                          start_timeout=start_timeout,
                          group_timeout=group_timeout, **engine_kw)
        self._respawnable = endpoints is None or spawn or \
            launcher is not None
        self._generation = 0
        self._rpc_deadline: Optional[float] = None
        self._inflight: Dict[int, object] = {}   # rid -> pristine clone
        self._dead = False
        self.failure: Optional[str] = None
        self.exitcodes: Optional[List[Optional[int]]] = None
        self.step_logs: List[List[dict]] = []    # per step, one per rank
        self.pool_checks = 0
        self.read_backs = 0
        timeout = datetime.timedelta(seconds=group_timeout)
        self._store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                                    wait_for_workers=False, timeout=timeout)
        host = ("127.0.0.1" if endpoints is None
                or all(map(is_loopback, endpoints)) else "")
        self.store_address = f"{host}:{self._store.port}"
        prefix = f"{self.label}-{os.getpid()}"
        ranks: List[Optional[EngineProxy]] = [None] * width
        errors: list = []

        def start(r):
            spec = {"store": self.store_address, "rank": r, "size": width,
                    "prefix": prefix, "device": devices[r],
                    "timeout": group_timeout}
            try:
                ranks[r] = EngineProxy(
                    cfg, params, start_timeout=start_timeout,
                    endpoint=endpoints[r] if endpoints else None,
                    spawn=endpoints is None or spawn,
                    peer_label=f"{self.label}/r{r}",
                    draw=draw, server=server, **dict(engine_kw, group=spec))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append((r, e))

        threads = [threading.Thread(target=start, args=(r,), daemon=True)
                   for r in range(width)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            for p in ranks:
                if p is not None:
                    p.quarantine()
            self._store = None
            r, e = min(errors, key=lambda x: x[0])
            raise RuntimeError(f"{self.label}: rank {r} of {width} failed "
                               f"to join its group: {e!r}") from e
        self.ranks: List[EngineProxy] = ranks
        self.lead = ranks[0]
        self.telemetry = self.lead.telemetry
        self.bringup = [dict(p.bringup, **p.info().get("bringup", {}))
                        for p in ranks]

    # ------------------------------------------------------------ fan-out
    def _issue(self, op: str, *args, **kw) -> list:
        """Send ``op`` to every rank, in rank order, without waiting."""
        if self._dead:
            raise TR.TransportClosed(f"{self.label} already dead ({op})")
        for k, r in enumerate(self.ranks):
            if not r.alive():
                self._fail(f"rank {k} dead before {op}")
                raise TR.TransportClosed(f"{self.label}: rank {k} is dead")
        pendings = []
        for k, r in enumerate(self.ranks):
            try:
                pendings.append(r.rpc.call_async(op, *args, **kw))
            except TR.TransportClosed as e:
                self._fail(f"rank {k} closed sending {op}")
                raise TR.TransportClosed(
                    f"{self.label}: rank {k} closed sending {op}") from e
        return pendings

    def _gather(self, op: str, pendings) -> list:
        """Every rank's reply to ``op``; an error on some ranks only is a
        mismatch. The first rank that resolves closed or hung fails the
        instance at once: its live peers wait in the call's collective
        for it and would not reply (the poll leaves them, resolved
        closed)."""
        res = TR.drain_pendings(pendings, first_failure=True)
        for k, (status, val) in enumerate(res):
            if status in ("closed", "hung") and \
                    not isinstance(val, TR.NotAwaited):
                self._fail(f"rank {k} {status} in {op}: {val}")
                raise TR.TransportClosed(
                    f"{self.label}: rank {k} {status} in {op}: {val}")
        errs = [(k, v) for k, (status, v) in enumerate(res)
                if status == "error"]
        if errs:
            if len(errs) == len(res) and len({str(v) for _, v in errs}) == 1:
                raise errs[0][1]
            k, v = errs[0]
            raise GroupMismatch(f"{self.label} {op}: rank {k} raised {v}, "
                                f"{len(res) - len(errs)} of {len(res)} "
                                f"ranks did not")
        return [v for _, v in res]

    def _all(self, op: str, *args, **kw) -> list:
        return self._gather(op, self._issue(op, *args, **kw))

    def _agree(self, op: str, values: list, what: str = "reply"):
        for k, v in enumerate(values[1:], 1):
            if v != values[0]:
                raise GroupMismatch(f"{self.label} {op}: rank {k}'s {what} "
                                    f"{v!r} differs from rank 0's "
                                    f"{values[0]!r}")
        return values[0]

    def _check_pools(self, op: str):
        """The ranks' pools bit-equal after ``op``."""
        self._agree(f"pools after {op}", self._all("pool_checksum"),
                    "pool checksum")
        self.pool_checks += 1

    def _fail(self, reason: str):
        """Sever every rank (closing its transport and killing the
        process it owns): a rank left alone waits in a collective."""
        if self._dead:
            return
        self._dead, self.failure = True, reason
        for r in self.ranks:
            r.quarantine()

    # ------------------------------------------------------ serving ops
    def submit(self, spec: RequestSpec, trace: Optional[dict] = None):
        self._inflight[spec.rid] = spec.to_request()
        q = self._agree("submit", self._all("submit", spec, _trace=trace),
                        "queue length")
        self.lead._info["queue_len"] = q

    def set_token_budget(self, budget: int) -> int:
        return int(self._agree("set_token_budget",
                               self._all("set_token_budget", int(budget))))

    def step(self) -> List:
        return self.finish_step(self.step_async().wait())

    def step_async(self) -> _GroupWait:
        return _GroupWait(self, "step", self._issue("step"), list)

    def finish_step(self, replies: list) -> List:
        base = replies[0]
        done0 = [(r.rid, list(r.generated)) for r in base["finished"]]
        for k, rep in enumerate(replies[1:], 1):
            done = [(r.rid, list(r.generated)) for r in rep["finished"]]
            if done != done0:
                i = next(i for i, (x, y) in enumerate(
                    itertools.zip_longest(done, done0)) if x != y)
                rid = (done[i] if i < len(done) else done0[i])[0]
                raise GroupMismatch(f"{self.label} step: rank {k} finished "
                                    f"rid {rid} unlike rank 0 ({done} against "
                                    f"{done0})")
            for rid, toks in base["streams"].items():
                if rep["streams"].get(rid) != toks:
                    raise GroupMismatch(
                        f"{self.label} step: rank {k}'s rid {rid} holds "
                        f"{rep['streams'].get(rid)}, rank 0's {toks}")
            if set(rep["streams"]) != set(base["streams"]):
                raise GroupMismatch(f"{self.label} step: rank {k} streams "
                                    f"rids {sorted(rep['streams'])}, rank 0 "
                                    f"{sorted(base['streams'])}")
            if rep["info"]["clock"] != base["info"]["clock"]:
                raise GroupMismatch(f"{self.label} step: rank {k}'s clock "
                                    f"{rep['info']['clock']}, rank 0's "
                                    f"{base['info']['clock']}")
            if rep["log"]["degrees"] != base["log"]["degrees"]:
                raise GroupMismatch(f"{self.label} step: rank {k} ran under "
                                    f"{rep['log']['degrees']}, rank 0 under "
                                    f"{base['log']['degrees']}")
        self.step_logs.append([rep["log"] for rep in replies])
        done = self.lead.finish_step(base)
        for r in done:
            self._inflight.pop(r.rid, None)
        return done

    def apply_plan(self, p):
        p = list(p.p) if hasattr(p, "p") else list(p)
        self._all("apply_plan", p)
        self._check_pools("apply_plan")

    def requeue_front(self, req):
        self._inflight[req.rid] = pristine(req)
        self.lead._info["queue_len"] = self._agree(
            "requeue_front", self._all("requeue_front", req))

    def push_queue(self, req):
        self._inflight[req.rid] = pristine(req)
        self.lead._info["queue_len"] = self._agree(
            "push_queue", self._all("push_queue", req))

    def drain_queue(self) -> List:
        outs = self._all("drain_queue")
        self._agree("drain_queue", [[r.rid for r in o] for o in outs],
                    "rids")
        for r in outs[0]:
            self._inflight.pop(r.rid, None)
        self.lead._info["queue_len"] = 0
        return outs[0]

    # ---------------------------------------------------------- tracing
    def register_trace(self, ctx: dict):
        self._all("trace_register", ctx)

    def drain_spans(self) -> List[dict]:
        return self.lead.drain_spans()

    # -------------------------------------------------------- telemetry
    def rank_infos(self) -> List[dict]:
        """Every rank's gauge dict, read now."""
        return self._all("info")

    def queue_len(self) -> int:
        return self.lead.queue_len()

    def active_rids(self) -> Dict[int, int]:
        return self.lead.active_rids()

    def free_blocks(self) -> int:
        return self.lead.free_blocks()

    def blocks_in_use(self) -> int:
        return self.lead.blocks_in_use()

    @property
    def n_blocks(self) -> int:
        return self.lead.n_blocks

    @property
    def max_batch(self) -> int:
        return self.lead.max_batch

    def pool_bytes(self) -> int:
        return self.lead.pool_bytes()

    def clock(self) -> float:
        return self.lead.clock()

    def preempt_count(self) -> int:
        return self.lead.preempt_count()

    def prefix_stats(self) -> dict:
        return self.lead.prefix_stats()

    @property
    def block_size(self) -> int:
        return self.lead.block_size

    def prefix_keys(self) -> set:
        return self.lead.prefix_keys()

    def stream_view(self) -> Dict[int, List[int]]:
        return self.lead.stream_view()

    # -------------------------------------------------------- migration
    def _unwrap_all(self, op: str, replies: list) -> list:
        out = [r._unwrap(rep) for r, rep in zip(self.ranks, replies)]
        backs = [rep.get("read_back") for rep in replies]
        if any(b is not None for b in backs):
            self._agree(op, backs, "blocks read back")
            self.read_backs += 1
        return out

    def _agree_payload(self, op: str, kvs: list):
        self._agree(op, [kv_digest(kv) for kv in kvs], "payload digest")

    def pause_request(self, slot: int,
                      since_epoch: Optional[int] = None) -> dict:
        pays = self._unwrap_all("pause_request", self._all(
            "pause_request", slot, since_epoch=since_epoch))
        self._agree("pause_request",
                    [(p["request"].rid, list(p["request"].generated))
                     for p in pays], "request")
        self._agree_payload("pause_request", [p["kv"] for p in pays])
        self._inflight.pop(pays[0]["request"].rid, None)
        self._check_pools("pause_request")
        return pays[0]

    def resume_request(self, payload: dict) -> bool:
        ok = self._agree("resume_request", self._unwrap_all(
            "resume_request", self._all("resume_request", payload)))
        if ok:
            self._inflight[payload["request"].rid] = \
                pristine(payload["request"])
        self._check_pools("resume_request")
        return ok

    def snapshot_request(self, slot: int) -> dict:
        snaps = self._all("snapshot_request", slot)
        self._agree_payload("snapshot_request", [s["kv"] for s in snaps])
        return snaps[0]

    def prepare_resume_async(self, snap: dict) -> _GroupWait:
        def finish(replies):
            slot = self._agree("prepare_resume", self._unwrap_all(
                "prepare_resume", replies), "slot")
            self._check_pools("prepare_resume")
            return slot
        return _GroupWait(self, "prepare_resume",
                          self._issue("prepare_resume", snap), finish)

    def commit_resume(self, slot: int, payload: dict) -> bool:
        ok = self._agree("commit_resume", self._unwrap_all(
            "commit_resume", self._all("commit_resume", slot, payload)))
        if ok:
            self._inflight[payload["request"].rid] = \
                pristine(payload["request"])
        self._check_pools("commit_resume")
        return ok

    def abort_resume(self, slot: int):
        self._unwrap_all("abort_resume", self._all("abort_resume", slot))
        self._check_pools("abort_resume")

    # --------------------------------------------------------- liveness
    def alive(self) -> bool:
        return not self._dead and all(r.alive() for r in self.ranks)

    def mark_dead(self):
        self._fail("marked dead")

    def set_rpc_deadline(self, seconds: Optional[float]):
        self._rpc_deadline = seconds
        for r in self.ranks:
            r.set_rpc_deadline(seconds)

    def probe(self, timeout: float = 1.0) -> str:
        if not self.alive():
            return "dead"
        verdicts = [r.probe(timeout) for r in self.ranks]
        if "dead" in verdicts:
            self._fail(f"rank {verdicts.index('dead')} dead on probe")
            return "dead"
        return "hung" if "hung" in verdicts else "alive"

    def quarantine(self):
        self._fail("quarantined")

    def inflight_requests(self) -> List:
        return list(self._inflight.values())

    @property
    def respawnable(self) -> bool:
        return self._respawnable

    @property
    def peer_label(self) -> str:
        """The instance's label, as a server's proxy carries its own (the
        supervisor's log reads it)."""
        return self.label

    def respawn(self, start_timeout: Optional[float] = None
                ) -> "GroupInstance":
        """A FRESH instance on the same cards with the same weights (the
        same draw or stream), as ``EngineProxy.respawn`` brings up one
        server: every rank process of this group joined first (a card
        holds no third server's weights), then a new store and a new
        group under the label ``<label>~r<n>`` (ranks ``<label>~r<n>/r<k>``:
        a static fault plan never re-targets the replacement). It starts
        empty; the supervisor re-admits it."""
        if not self._respawnable:
            raise RuntimeError(f"{self.label} attaches to servers that are "
                               "not its own to restart")
        self.close()
        spec = dict(self._spec)
        if start_timeout is not None:
            spec["start_timeout"] = start_timeout
        gen = self._generation + 1
        fresh = GroupInstance(label=f"{self.label.split('~', 1)[0]}~r{gen}",
                              **spec)
        fresh._generation = gen
        fresh.set_rpc_deadline(self._rpc_deadline)
        return fresh

    def close(self):
        """Shut every rank down together (a failed instance's ranks were
        severed already), join the processes and free the group's store;
        ``exitcodes`` holds the processes' exit codes (None for a server
        this handle did not spawn)."""
        if self.exitcodes is not None:
            return
        if not self.alive():
            self._fail(self.failure or "a rank died")
        else:
            try:
                self._gather("shutdown", self._issue("shutdown"))
            except TR.TransportError:
                pass
            self._dead = True
        deadline = time.monotonic() + 60.0
        for r in self.ranks:
            r._dead = True
            if r.process is not None:
                r.process.join(timeout=max(0.0, deadline - time.monotonic()))
                if r.process.is_alive():   # pragma: no cover - stuck child
                    r.process.kill()
                    r.process.join(timeout=10)
            r.rpc.close()
        self.exitcodes = [r.process.exitcode if r.process is not None
                          else None for r in self.ranks]
        self._store = None
