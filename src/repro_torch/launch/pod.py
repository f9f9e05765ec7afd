"""Node-inventory pod launcher — the multi-HOST deployment unit of the
distributed serving plane.

A *pod* is described by a small TOML (or JSON) inventory of nodes::

    # pod.toml — one [[node]] table per machine
    [[node]]
    host = "127.0.0.1"      # where the engine servers listen
    port = 7101             # first TCP port on that host
    capacity = 2            # engine instances on the node
                            #   -> endpoints port .. port+capacity-1
    spawn = true            # true:  spawn the servers locally (the
                            #        host must be THIS machine)
                            # false: attach to servers already running
                            #        there (started on the node via
                            #        `python -m repro_torch.launch.pod
                            #         --serve tcp://0.0.0.0:7101`)

``load_inventory`` expands that into one ``tcp://host:port`` endpoint
per instance; ``launch_pod`` turns the endpoints into live
``EngineProxy`` handles — spawning listening engine-server processes
for ``spawn`` nodes and dialing (with connect-retry while the remote
bind races the connect) into already-running ones for the rest. The
orchestrator's §5 control loop drives the resulting handles unchanged:
``InstanceHandle`` hides the transport entirely, so scaling decisions,
overlapped two-phase migration, and crash replay behave identically
whether the instances share this process, this machine, or neither.

CLI::

    # on each worker node: one listening engine server per instance
    python -m repro_torch.launch.pod --serve tcp://0.0.0.0:7101

    # on the orchestrator node: drive the whole pod
    python -m repro_torch.launch.serve --inventory pod.toml --requests 24

**Trust boundary**: the wire protocol carries pickle frames (the init
message ships config + params) and performs no authentication — a
listening engine server executes whatever a connecting peer sends, so
endpoints must only be reachable from the trusted network segment the
pod runs on (bind a private interface, not a public one), exactly like
the intra-cluster RPC planes of mainstream serving stacks.

On a host whose instances span W cards (``launch.serve`` with two or
more cards visible), a node's ``capacity`` counts group instances, each
of W consecutive endpoints (``launch_group_pod``); the schema is the
same.

Counterpart of ``repro.launch.pod`` for the port. The engine kwargs
(``device`` among them) and the weights travel in each server's init
stream, so a listening server needs nothing beyond its endpoint; on one
card every engine server of a pod holds its own CUDA context there.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

try:                      # 3.11+ stdlib
    import tomllib as _toml
except ImportError:       # 3.10: the vendored backport
    try:
        import tomli as _toml  # type: ignore
    except ImportError:   # pragma: no cover - one of the two is baked in
        _toml = None


@dataclasses.dataclass
class Node:
    """One inventory row: ``capacity`` engine instances on ``host``,
    listening on consecutive TCP ports starting at ``port``."""
    host: str
    port: int
    capacity: int = 1
    spawn: bool = True

    def endpoints(self, width: int = 1) -> List[str]:
        """The node's endpoints: ``width`` consecutive ports an instance
        (one engine server a rank of a group instance)."""
        return [f"tcp://{self.host}:{self.port + k}"
                for k in range(self.capacity * width)]

    def name(self) -> str:
        return f"{self.host}:{self.port}"


def parse_inventory(doc: dict, origin: str = "<inventory>") -> List[Node]:
    """Validate one decoded inventory document into ``Node`` rows."""
    rows = doc.get("node")
    if not isinstance(rows, list) or not rows:
        raise ValueError(f"{origin}: expected a non-empty [[node]] list")
    nodes = []
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            raise ValueError(f"{origin}: node #{i} is not a table")
        unknown = set(row) - {"host", "port", "capacity", "spawn"}
        if unknown:
            raise ValueError(f"{origin}: node #{i} has unknown keys "
                             f"{sorted(unknown)}")
        try:
            node = Node(host=str(row["host"]), port=int(row["port"]),
                        capacity=int(row.get("capacity", 1)),
                        spawn=bool(row.get("spawn", True)))
        except KeyError as e:
            raise ValueError(f"{origin}: node #{i} missing key {e}") from e
        if node.capacity < 1:
            raise ValueError(f"{origin}: node #{i} capacity must be >= 1")
        if not 0 < node.port < 65536:
            raise ValueError(f"{origin}: node #{i} port {node.port} "
                             "out of range")
        nodes.append(node)
    check_endpoints(nodes, 1, origin)
    return nodes


def check_endpoints(nodes: List[Node], width: int,
                    origin: str = "<inventory>"):
    """Raise unless no two nodes share an endpoint at ``width`` ranks an
    instance, naming the nodes."""
    seen: dict = {}
    for i, node in enumerate(nodes):
        for ep in node.endpoints(width):
            if ep in seen:
                raise ValueError(
                    f"{origin}: endpoint {ep} appears in both node "
                    f"#{seen[ep]} and node #{i} (overlapping port "
                    "ranges) — two servers cannot share it")
            seen[ep] = i


def load_inventory(path: str) -> List[Node]:
    """Read a ``.toml`` or ``.json`` inventory file into ``Node`` rows.
    JSON uses the same shape: ``{"node": [{"host": ..., ...}, ...]}``."""
    if path.endswith(".json"):
        with open(path) as f:
            return parse_inventory(json.load(f), origin=path)
    if _toml is None:  # pragma: no cover - tomli/tomllib is baked in
        raise RuntimeError("TOML inventory needs tomllib (py3.11+) or "
                           "tomli; use a .json inventory instead")
    with open(path, "rb") as f:
        return parse_inventory(_toml.load(f), origin=path)


def launch_pod(cfg, params, nodes: List[Node], *,
               start_timeout: float = 120.0,
               pod_timeout: Optional[float] = None,
               width: int = 1, draw: Optional[dict] = None,
               **engine_kw) -> list:
    """Bring up one ``EngineProxy`` per inventory endpoint and return
    the handle list for ``Orchestrator(handles=...)``.

    Two phases so startup tracks the slowest node, not the sum: first
    EVERY ``spawn`` node's server process is started (they boot their
    interpreters, import torch, and bind concurrently), then each
    endpoint is dialed and fed its init frame (the proxy adopts the
    pre-spawned child so liveness/kill still see it). On any failure,
    handles brought up so far are closed and spawned-but-unadopted
    servers are reaped before the error propagates (no orphan
    processes).

    ``start_timeout`` bounds each node's OWN bring-up (dial + init
    handshake); ``pod_timeout`` is the TOTAL wall deadline for the
    whole launch — with it, one never-booting node fails the pod fast
    (per-endpoint budget = whatever remains of the pod deadline)
    instead of serially eating a full ``start_timeout`` per endpoint.

    Proxies are labeled ``w0..wN-1`` in inventory order — the stable
    per-peer identity the fault-injection plans of
    ``serving/faults.py`` target (free-port inventories keep the same
    labels run to run, so a seeded chaos plan stays reproducible).

    With ``width`` above 1 each node holds ``capacity`` group instances
    (``launch_group_pod``): ``width`` consecutive endpoints each, whose
    servers draw ``draw`` (or take ``params``' stream)."""
    import multiprocessing as mp
    import time

    if width > 1:
        return launch_group_pod(cfg, params, nodes, width=width, draw=draw,
                                start_timeout=(start_timeout
                                               if pod_timeout is None else
                                               min(start_timeout,
                                                   pod_timeout)),
                                **engine_kw)

    from repro_torch.serving.remote_engine import (EngineProxy,
                                                   engine_server_listen)
    from repro_torch.serving.transport import TransportError

    deadline = (None if pod_timeout is None
                else time.monotonic() + pod_timeout)
    ctx = mp.get_context("spawn")
    plan = []                       # (endpoint, spawned process | None)
    handles = []
    try:
        for node in nodes:
            for ep in node.endpoints():
                proc = None
                if node.spawn:
                    proc = ctx.Process(target=engine_server_listen,
                                       args=(ep,), daemon=True)
                    proc.start()
                plan.append((ep, proc))
        for k, (ep, proc) in enumerate(plan):
            budget = start_timeout
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TransportError(
                        f"pod bring-up deadline ({pod_timeout:.1f}s) "
                        f"exceeded with {len(handles)}/{len(plan)} "
                        f"instances up (next: {ep})")
                budget = min(budget, remaining)
            handles.append(EngineProxy(
                cfg, params, endpoint=ep, spawn=False, adopt_process=proc,
                start_timeout=budget, peer_label=f"w{k}", **engine_kw))
    except Exception:
        for h in handles:
            try:
                h.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        adopted = {id(h.process) for h in handles if h.process is not None}
        for _, proc in plan:
            if proc is not None and id(proc) not in adopted \
                    and proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
        raise
    return handles


def launch_group_pod(cfg, params, nodes: List[Node], *, width: int,
                     draw: Optional[dict] = None, start_timeout: float = 120.0,
                     **engine_kw) -> list:
    """One ``serving.group.GroupInstance`` per ``width`` consecutive
    endpoints of each node (``capacity`` of them a node), labelled
    ``w0..`` in inventory order, all brought up at once: a ``spawn``
    node's servers are spawned listening at its endpoints (such an
    instance respawns), an attach node's are dialled (such an instance
    does not). A node whose ranks cannot form an instance fails the
    bring-up, naming the node; the instances that came up are closed."""
    from repro_torch.serving.group import GroupInstance, start_all

    for i, node in enumerate(nodes):
        last = node.port + node.capacity * width - 1
        if last >= 65536:
            raise ValueError(
                f"node #{i} ({node.name()}) cannot form {node.capacity} "
                f"instances of {width} ranks: port {last} out of range")
    check_endpoints(nodes, width)
    makers = []
    for node in nodes:
        eps = node.endpoints(width)
        for i in range(node.capacity):
            def make(node=node, k=len(makers),
                     ranks=eps[i * width:(i + 1) * width]):
                try:
                    return GroupInstance(
                        cfg, params, width=width, draw=draw, endpoints=ranks,
                        spawn=node.spawn, label=f"w{k}",
                        start_timeout=start_timeout, **engine_kw)
                except Exception as e:
                    raise RuntimeError(
                        f"node {node.name()} ({'spawn' if node.spawn else 'attach'}) "
                        f"could not form instance w{k} of {width} ranks at "
                        f"{ranks[0]}..{ranks[-1]}: {e}") from e
            makers.append(make)
    return start_all(makers)


def make_worker_factory(cfg, params, *, remote: bool = False,
                        width: int = 1, draw: Optional[dict] = None,
                        **engine_kw):
    """Return the ``idx -> InstanceHandle`` callable that arms the
    orchestrator's RUNTIME pod growth (``Orchestrator.grow_pod``): the
    controller's grow decision spawns a whole fresh serving instance
    through it mid-flight, after launch. ``remote=True`` spawns an
    engine-server process and returns its ``EngineProxy`` (the same
    plane launch-time ``--workers`` instances live on); the default
    builds an in-process paged ``LocalInstance`` — enough for tests and
    single-host elasticity without process spin-up cost.

    With ``width`` above 1 it builds a ``serving.group.GroupInstance`` of
    ``width`` spawned engine servers, one a card, whose weights come by
    ``draw`` (or as ``params``' stream): the instance a host with several
    cards serves.

    Grown workers are labeled ``g<idx>`` — disjoint from the
    launch-time ``w<k>`` namespace, so fault-injection plans and logs
    can tell a runtime spawn from the original fleet."""
    if width > 1:
        from repro_torch.serving.group import GroupInstance

        def factory(idx: int):
            return GroupInstance(cfg, params, width=width, draw=draw,
                                 label=f"g{idx}", **engine_kw)
    elif remote:
        from repro_torch.serving.remote_engine import EngineProxy

        def factory(idx: int):
            return EngineProxy(cfg, params, peer_label=f"g{idx}",
                               **engine_kw)
    else:
        from repro_torch.serving.engine import Engine
        from repro_torch.serving.instance import LocalInstance

        def factory(idx: int):
            return LocalInstance(Engine(cfg, params, cache_kind="paged",
                                        **engine_kw))
    return factory


def main(argv: Optional[List[str]] = None) -> int:
    """``--serve ENDPOINT``: run ONE listening engine server in this
    process (the per-node worker entry; the orchestrator ships cfg +
    params in its init stream, so the node needs no local copy).
    ``--show INVENTORY``: print the endpoint expansion and exit."""
    import argparse

    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--serve", metavar="ENDPOINT",
                   help="listen on tcp://host:port, serve one "
                        "orchestrator connection, exit")
    g.add_argument("--show", metavar="INVENTORY",
                   help="parse an inventory file and print its "
                        "endpoints")
    args = ap.parse_args(argv)

    if args.show:
        for node in load_inventory(args.show):
            mode = "spawn" if node.spawn else "attach"
            for ep in node.endpoints():
                print(f"{ep}  ({mode})")
        return 0

    from repro_torch.serving.remote_engine import engine_server_listen
    print(f"[pod] engine server listening on {args.serve}", flush=True)
    engine_server_listen(args.serve)
    print("[pod] orchestrator disconnected; exiting", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
