"""Deterministic fault injection for the distributed serving plane.

The failure-domain layer (DESIGN.md §9) is only trustworthy if its
recovery paths can be *driven*, repeatably, through the same wire the
real failures arrive on. This module is that driver: a ``FaultPlan`` is
a seeded schedule of per-peer fault events, and a ``FaultInjector``
replays it inside ``transport.Connection.send`` via the
``set_fault_hook`` seam — so a "partition" is literally frames that
never reach the wire, not a mock.

Determinism: events are keyed on each peer's *send-op index* (the n-th
frame sent to that peer since the injector was installed), never on
wall-clock time — the same plan against the same driving sequence
faults the same frames, byte for byte. The one wall-clock-shaped event,
``kill``, is keyed on an orchestrator *step index* and executed by the
driving loop (``kills_due``), not by the hook, because killing a
process is not a send-side effect.

Fault kinds:

* ``delay``     — sleep ``delay_s`` before delivering one frame;
* ``drop``      — swallow exactly one frame (a lost request: the peer
                  stays healthy, only that call never happens);
* ``half_open`` — from ``at_op`` on, swallow EVERY frame to the peer
                  while its socket stays open (the classic blackhole:
                  deadline-detection territory, never TransportClosed);
* ``partition`` — swallow frames for a window of ``span`` ops, then
                  heal (a transient partition a probe may outwait);
* ``kill``      — SIGKILL the peer's process at step ``at_step``
                  (driver-executed; real process death, real EOF).

Peers are addressed by ``Connection.peer_label`` — ``launch_pod``
labels its proxies ``w0..wN-1`` and a respawned worker gets an
incarnation suffix (``w1~r1``), so a static plan never re-targets the
replacement of a peer it already killed.

``REPRO_FAULTS=<plan.json>`` installs a serialized plan at transport
import (see ``transport._install_env_faults``). Worker processes
inherit the variable but only hold unlabeled connections, so the plan
is inert in them.

Copy of ``repro.serving.faults`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("delay", "drop", "half_open", "partition", "kill")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault against one peer. ``at_op`` is the per-peer
    send-op index (ignored for ``kill``); ``at_step`` is the driving
    loop's step index (``kill`` only); ``span`` is the op-window width
    (``partition`` only); ``delay_s`` (``delay`` only)."""
    peer: str
    kind: str
    at_op: int = 0
    span: int = 1
    delay_s: float = 0.0
    at_step: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(want one of {KINDS})")


@dataclasses.dataclass
class FaultPlan:
    """A reproducible schedule of fault events (JSON round-trippable
    for the ``REPRO_FAULTS`` environment hook)."""
    events: List[FaultEvent] = dataclasses.field(default_factory=list)
    seed: Optional[int] = None

    @classmethod
    def seeded(cls, seed: int, peers: Sequence[str], *,
               kill_window: Tuple[int, int] = (2, 6),
               hang_window: Tuple[int, int] = (8, 16),
               partition_window: Tuple[int, int] = (8, 16),
               partition_span: int = 64,
               n_delays: int = 4,
               delay_s: float = 0.02,
               delay_window: Tuple[int, int] = (0, 40)) -> "FaultPlan":
        """The ISSUE-6 chaos mix — ONE kill (at a step drawn from
        ``kill_window``), ONE hang (half-open from an op in
        ``hang_window``), ONE partition (op window), plus ``n_delays``
        sprinkled delays per peer — drawn deterministically from
        ``seed``. Peer roles are a seeded shuffle of ``peers``; with
        fewer than three peers roles overlap (first fault to fire
        wins)."""
        rng = np.random.default_rng(seed)
        order = list(peers)
        rng.shuffle(order)
        kill = order[0]
        hang = order[1 % len(order)]
        part = order[2 % len(order)]
        events = [
            FaultEvent(peer=kill, kind="kill",
                       at_step=int(rng.integers(*kill_window))),
            FaultEvent(peer=hang, kind="half_open",
                       at_op=int(rng.integers(*hang_window))),
            FaultEvent(peer=part, kind="partition",
                       at_op=int(rng.integers(*partition_window)),
                       span=partition_span),
        ]
        for peer in peers:
            for _ in range(n_delays):
                events.append(FaultEvent(
                    peer=peer, kind="delay",
                    at_op=int(rng.integers(*delay_window)),
                    delay_s=delay_s))
        return cls(events=events, seed=seed)

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "events": [dataclasses.asdict(e) for e in self.events]}

    @classmethod
    def from_json(cls, doc: dict) -> "FaultPlan":
        return cls(events=[FaultEvent(**e) for e in doc.get("events", [])],
                   seed=doc.get("seed"))

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


class FaultInjector:
    """Replays a ``FaultPlan`` against labeled connections. One op
    counter per peer label, advanced on every send the hook sees —
    including swallowed ones, so the schedule is insensitive to its own
    effects. ``arm`` adds events dynamically (tests aim a fault at "the
    very next send" without precomputing op indices)."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self._sent: Dict[str, int] = {}
        self._delays: Dict[str, Dict[int, float]] = {}
        self._drops: Dict[str, set] = {}
        self._half_open: Dict[str, int] = {}
        self._partitions: Dict[str, List[Tuple[int, int]]] = {}
        self._kills: Dict[int, List[str]] = {}
        self.injected = {k: 0 for k in KINDS}
        for ev in self.plan.events:
            self._index(ev)

    def _index(self, ev: FaultEvent):
        if ev.kind == "delay":
            self._delays.setdefault(ev.peer, {})[ev.at_op] = ev.delay_s
        elif ev.kind == "drop":
            self._drops.setdefault(ev.peer, set()).add(ev.at_op)
        elif ev.kind == "half_open":
            cur = self._half_open.get(ev.peer)
            self._half_open[ev.peer] = (ev.at_op if cur is None
                                        else min(cur, ev.at_op))
        elif ev.kind == "partition":
            self._partitions.setdefault(ev.peer, []).append(
                (ev.at_op, ev.at_op + ev.span))
        elif ev.kind == "kill":
            self._kills.setdefault(ev.at_step, []).append(ev.peer)

    def arm(self, peer: str, kind: str, at_op: Optional[int] = None, **kw):
        """Schedule one more event; ``at_op=None`` targets the peer's
        NEXT send."""
        if at_op is None and kind != "kill":
            at_op = self._sent.get(peer, 0)
        ev = FaultEvent(peer=peer, kind=kind, at_op=at_op or 0, **kw)
        self.plan.events.append(ev)
        self._index(ev)

    def on_send(self, peer: str) -> bool:
        """The hook body: advance ``peer``'s op counter, apply any
        delay, and return False if the frame must be swallowed."""
        op = self._sent.get(peer, 0)
        self._sent[peer] = op + 1
        deliver = True
        start = self._half_open.get(peer)
        if start is not None and op >= start:
            self.injected["half_open"] += 1
            deliver = False
        elif any(lo <= op < hi
                 for lo, hi in self._partitions.get(peer, ())):
            self.injected["partition"] += 1
            deliver = False
        elif op in self._drops.get(peer, ()):
            self.injected["drop"] += 1
            deliver = False
        delay = self._delays.get(peer, {}).get(op)
        if delay:
            self.injected["delay"] += 1
            time.sleep(delay)
        return deliver

    def kills_due(self, step: int) -> List[str]:
        """Peers whose ``kill`` event fires at ``step`` (consumed:
        asking again returns []). The DRIVER executes these — process
        death is not a send-side effect."""
        peers = self._kills.pop(step, [])
        self.injected["kill"] += len(peers)
        return peers

    def ops_sent(self, peer: str) -> int:
        return self._sent.get(peer, 0)

    def total_injected(self) -> int:
        return sum(self.injected.values())


# ------------------------------------------------------ global install
_ACTIVE: Optional[FaultInjector] = None


def _hook(conn) -> bool:
    inj = _ACTIVE
    if inj is None or conn.peer_label is None:
        return True
    return inj.on_send(conn.peer_label)


def install(plan_or_injector) -> FaultInjector:
    """Activate fault injection process-wide (labeled connections
    only). Returns the live injector so drivers can ``arm`` /
    ``kills_due`` / read counters."""
    global _ACTIVE
    inj = (plan_or_injector if isinstance(plan_or_injector, FaultInjector)
           else FaultInjector(plan_or_injector))
    _ACTIVE = inj
    from repro_torch.serving import transport as TR
    TR.set_fault_hook(_hook)
    return inj


def install_from_file(path: str) -> FaultInjector:
    return install(FaultPlan.load(path))


def uninstall():
    global _ACTIVE
    _ACTIVE = None
    from repro_torch.serving import transport as TR
    TR.set_fault_hook(None)


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def injected_total() -> int:
    """Process-wide injected-fault count (0 with no injector) — the
    ``faults_injected`` gauge in ``MetricsSnapshot``."""
    return _ACTIVE.total_injected() if _ACTIVE is not None else 0
