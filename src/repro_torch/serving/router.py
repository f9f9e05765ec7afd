"""Request routing policies for the serving front door.

The ingress (serving/ingress.py) and the orchestrator's ``submit`` both
answer the same question: WHICH instance should take this request? Before
this module the answer was hardcoded vacancy (most free pool blocks);
now it is a swappable policy object, and the default exploits the one
signal only the router can see pod-wide: PR 3's content-chain prefix
keys.

**Prefix-affinity routing** (``PrefixAffinityRouter``, the default,
after Ray Serve's prefix-aware LLMRouter): the router hashes the
incoming prompt through ``paged_kv._chain_keys`` — the SAME chain hash
the engines key their prefix caches by, so "the router thinks instance
i holds this prefix" and "instance i's cache hits on it" can never
disagree about what a match means — and prefers the instance whose
resident key set covers the LONGEST leading chain of the prompt. A hit
routed to its chain holder prefills only the suffix and allocates no
blocks for the shared span; the same request routed anywhere else
re-prefills and re-stores the whole prefix. Resident key sets ride the
step replies (``EngineServer.info["prefix_keys"]``), so the router's
view refreshes once per orchestrator step with zero extra RPCs — it can
be one step stale, which costs a miss, never correctness.

When no chain matches (or scores tie) the policy falls back to the
orchestrator's historical order: most free pool blocks, then shortest
queue, then lowest index — fully deterministic, asserted by
tests/test_router.py.

**Admission backpressure**: ``select`` only considers instances whose
queue (plus tokens the ingress has accepted but not yet submitted — the
``pending`` map) is below ``max_queue``. When NO alive instance is
admissible it returns None and the ingress answers 429 + Retry-After
instead of queueing unboundedly — load shedding at the front door, not
OOM at the pool.

**SLO-aware admission**: the decision sees the full ``RequestSpec``
(serving/request.py), not just the prompt. Batch-class requests get one
seat LESS of queue headroom per instance: under sustained pressure the
pod sheds batch traffic a beat before it sheds interactive/standard
traffic, so the latency classes always find the last seat. (Scheduling
WITHIN an admitted queue is the engine scheduler's job — the router
only decides who gets through the door.)

``RoundRobinRouter`` is the affinity-blind baseline the ingress bench
measures against (BENCH_ingress.json's >= 1.5x pod-wide hit-rate gate).

Copy of ``repro.serving.router`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.serving import paged_kv as PK


@dataclasses.dataclass
class RouteDecision:
    """One routing verdict: the chosen instance, how many leading prompt
    blocks its prefix cache already holds, and which rule decided
    (``"prefix"`` when the chain match broke the tie, ``"vacancy"``
    otherwise)."""
    idx: int
    matched_blocks: int = 0
    reason: str = "vacancy"

    def as_event(self) -> dict:
        """Flight-recorder payload for this verdict (observe.FlightRecorder
        ``route`` events) — plain dict, msgpack/JSON-safe."""
        return {"idx": self.idx, "matched_blocks": self.matched_blocks,
                "reason": self.reason}


def chain_hexkeys(prompt, block_size: int) -> List[str]:
    """The prompt's content-chain keys (one per FULL block), hex-encoded
    to match the resident sets handles export over the wire."""
    if prompt is None or block_size <= 0:
        return []
    return [k.hex() for k in PK._chain_keys(prompt, block_size)]


class RouterPolicy:
    """Interface: pick one of ``among`` (indices into ``handles``) for a
    request, or None when admission must back off. ``spec`` is the
    request's ``RequestSpec`` (admission is class-aware — see module
    docstring); ``prompt`` alone still works for spec-less internal
    callers (replay, migration re-homing). ``pending`` maps instance
    index -> requests accepted upstream (by the ingress) but not yet
    visible in ``queue_len`` — the router charges them so a burst
    cannot over-admit between steps."""

    def select(self, handles: Sequence, among: Sequence[int], *,
               spec=None, prompt=None,
               pending: Optional[Dict[int, int]] = None,
               max_queue: Optional[int] = None) -> Optional[RouteDecision]:
        raise NotImplementedError


def _load(handles, idx: int, pending: Dict[int, int]):
    """The vacancy-order key the orchestrator has always routed by:
    most free blocks first, then shortest (queue + pending), then lowest
    index — the deterministic tiebreak."""
    h = handles[idx]
    return (-h.free_blocks(), h.queue_len() + pending.get(idx, 0), idx)


def _headroom(spec, max_queue) -> Optional[int]:
    """Class-adjusted admission bound: batch traffic may not take an
    instance's LAST queue seat (when there is more than one)."""
    if max_queue is None or spec is None:
        return max_queue
    if getattr(spec, "slo_class", "standard") == "batch" and max_queue > 1:
        return max_queue - 1
    return max_queue


def _admissible(handles, among, pending, max_queue) -> List[int]:
    if max_queue is None:
        return list(among)
    return [i for i in among
            if handles[i].queue_len() + pending.get(i, 0) < max_queue]


class PrefixAffinityRouter(RouterPolicy):
    """The default pod router (module docstring). ``min_match`` is the
    affinity floor: chains shorter than this many blocks are noise (a
    one-block match saves less than an imbalanced queue costs) and fall
    through to vacancy order."""

    def __init__(self, min_match: int = 1):
        self.min_match = max(1, int(min_match))

    def _matched(self, handle, keys: List[str]) -> int:
        """Longest LEADING run of the prompt's chain resident at this
        handle. Leading is the point: chain key c certifies tokens
        [0, (c+1)*bs) only when every earlier block is there to alias."""
        if not keys:
            return 0
        resident = handle.prefix_keys()
        if not resident:
            return 0
        n = 0
        for k in keys:
            if k not in resident:
                break
            n += 1
        return n

    def select(self, handles, among, *, spec=None, prompt=None,
               pending=None, max_queue=None) -> Optional[RouteDecision]:
        pending = pending or {}
        if prompt is None and spec is not None:
            prompt = spec.prompt
        cands = _admissible(handles, among, pending,
                            _headroom(spec, max_queue))
        if not cands:
            return None
        best = None
        if prompt is not None:
            # per-candidate block size: a heterogeneous pod hashes per
            # instance (chain keys are block-size-dependent)
            by_bs: Dict[int, List[str]] = {}
            scored = []
            for i in cands:
                bs = handles[i].block_size
                keys = by_bs.setdefault(bs, chain_hexkeys(prompt, bs))
                scored.append((self._matched(handles[i], keys), i))
            top = max(m for m, _ in scored)
            if top >= self.min_match:
                tied = [i for m, i in scored if m == top]
                idx = min(tied, key=lambda i: _load(handles, i, pending))
                best = RouteDecision(idx, matched_blocks=top,
                                     reason="prefix")
        if best is None:
            idx = min(cands, key=lambda i: _load(handles, i, pending))
            best = RouteDecision(idx)
        return best


class VacancyRouter(RouterPolicy):
    """Pure load routing — the pre-ingress ``Orchestrator.submit``
    behavior, kept as an explicit policy (and the affinity router's
    fallback order)."""

    def select(self, handles, among, *, spec=None, prompt=None,
               pending=None, max_queue=None) -> Optional[RouteDecision]:
        pending = pending or {}
        cands = _admissible(handles, among, pending,
                            _headroom(spec, max_queue))
        if not cands:
            return None
        return RouteDecision(min(cands,
                                 key=lambda i: _load(handles, i, pending)))


class RoundRobinRouter(RouterPolicy):
    """Affinity-blind baseline (bench control arm): strict rotation over
    the admissible candidates, skipping full ones."""

    def __init__(self):
        self._next = 0

    def select(self, handles, among, *, spec=None, prompt=None,
               pending=None, max_queue=None) -> Optional[RouteDecision]:
        pending = pending or {}
        cands = _admissible(handles, among, pending,
                            _headroom(spec, max_queue))
        if not cands:
            return None
        idx = cands[self._next % len(cands)]
        self._next += 1
        return RouteDecision(idx)
