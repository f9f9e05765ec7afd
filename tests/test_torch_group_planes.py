"""Port parity, the serving planes over group instances
(``serving.group.GroupInstance`` under ``--supervise``, ``--elastic``,
``--inventory`` and ``--workers``): each rank's engine server runs on a
thread of this process behind a real AF_UNIX or TCP connection, the
ranks of a group joined over gloo; no process is spawned. A rank that
dies inside a step fails its instance at once and its streams replay to
the reference's tokens; a respawned instance comes back under a new
label, store and group and serves a pinned request to the reference's
tokens; a grouped worker factory grows the pod by a whole group that
takes routed traffic, and a shrink hands its streams off token for
token; ``launch_pod`` groups a node's endpoints into instances; the
group's store is advertised at the address a node reaches it by; and
``launch.serve`` builds grouped handles of four cards on every plane and
draws no weights itself."""
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core import replication as R
from repro_torch.core.controller import PodElasticityConfig
from repro_torch.launch import pod as POD
from repro_torch.launch import serve as S
from repro_torch.models import transformer as T
from repro_torch.serving import group as G
from repro_torch.serving import remote_engine as RE
from repro_torch.serving import transport as TR
from repro_torch.serving.instance import InstanceHandle
from repro_torch.serving.instrument import EngineTelemetry
from repro_torch.serving.orchestrator import Orchestrator, RespawnPolicy
from _torch_parity import jax_solo_streams, specs, tiny_pair
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import partitionable_threefry  # noqa: F401

pytestmark = pytest.mark.usefixtures("partitionable_threefry")
KW = dict(max_batch=4, max_len=64, block_size=8, n_blocks=24, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


class _Servers:
    """Engine servers on threads of this process, each listening at its
    endpoint for one connection (``start``); ``launcher(W)`` hands a
    GroupInstance W fresh ones at every call. ``close`` closes what the
    test registered (``own``) and joins every server thread."""

    def __init__(self):
        self.threads, self.conns, self.errors, self.owned = {}, {}, [], []

    def start(self, addrs):
        n = torch.get_num_threads()
        for a in addrs:
            self.threads[a] = threading.Thread(target=self._run, args=(a, n),
                                               daemon=True)
            self.threads[a].start()
        return list(addrs)

    def launcher(self, width):
        return lambda: self.start([TR.listener_address()
                                   for _ in range(width)])

    def _run(self, addr, n):
        torch.set_num_threads(n)   # every rank at the caller's count
        try:
            srv = TR.listen(addr)
            try:
                conn = TR.accept(srv, timeout=None)
            finally:
                srv.close()
            self.conns[addr] = conn
            RE._serve_connection(conn)
        except Exception as e:  # noqa: BLE001 - read by the test
            self.errors.append(e)

    def own(self, x):
        self.owned.append(x)
        return x

    def close(self):
        for x in self.owned:
            x.close()
        for t in self.threads.values():
            t.join(timeout=30)
        assert not any(t.is_alive() for t in self.threads.values())


@pytest.fixture
def servers():
    s = _Servers()
    yield s
    s.close()


def _rows(n, max_tokens, rid0=0, temperature=0.0, top_k=0):
    return [(rid0 + i, np.arange(2 + i, 12 + 2 * i, dtype=np.int32),
             max_tokens, temperature, top_k, 7 + i) for i in range(n)]


def _streams(orch):
    return {r.rid: list(r.generated) for r in orch.finished}


def test_rank_dying_inside_a_step_fails_its_instance_at_once(
        tiny, servers, monkeypatch):
    """Rank 1 of instance 0 loses its connection once rank 0 waits in the
    step's collective, and stays in the group, as a killed process's
    peers on the card keep waiting in a replayed graph: the instance is
    dead within 5 s, with no RPC deadline armed and the collective's
    timeout at 10 s, and its streams replay on instance 1 to the
    reference's tokens."""
    jcfg, jp, tcfg, tp = tiny
    L = tcfg.num_layers
    rows = _rows(4, 10)
    target, entered, release, closed_at = {}, threading.Event(), \
        threading.Event(), []
    run, step = R.ReplicationGroup._run, RE.EngineServer.step

    def run_(self, kind, op):
        if threading.current_thread() is target.get(0):
            entered.set()
        return run(self, kind, op)

    def step_(self):
        if threading.current_thread() is not target.get(1):
            return step(self)
        assert entered.wait(30)
        time.sleep(0.05)   # rank 0 waits in the collective
        target["conn"].close()
        closed_at.append(time.monotonic())
        release.wait(30)   # the group lives on, as a killed rank's NCCL peers'
        raise TR.TransportClosed("rank 1 died inside the step")

    monkeypatch.setattr(R.ReplicationGroup, "_run", run_)
    monkeypatch.setattr(RE.EngineServer, "step", step_)
    launch = servers.launcher(2)
    h0 = servers.own(G.GroupInstance(tcfg, tp, width=2, launcher=launch,
                                     group_timeout=10.0, **KW))
    h1 = servers.own(G.GroupInstance(tcfg, tp, width=2, launcher=launch,
                                     **KW))
    orch = Orchestrator(tcfg, None, handles=[h0, h1], telemetry_every=10_000)
    try:
        for s in specs(rows, jax_side=False):
            orch.submit_to(s.rid % 2, s)
        orch._on_plan_change(types.SimpleNamespace(p=[2] * L), 2)
        for _ in range(3):
            orch.step()
        assert h0.active_rids()
        ep = [r.endpoint for r in h0.ranks]
        target.update({0: servers.threads[ep[0]], 1: servers.threads[ep[1]],
                       "conn": servers.conns[ep[1]]})
        orch.step()
        dead_after = time.monotonic() - closed_at[0]
        assert not h0.alive() and "rank 1 closed in step" in h0.failure
        assert dead_after < 5.0, dead_after
        assert [r["instance"] for r in orch.recoveries] == [0]
    finally:
        release.set()
    orch.run_until_done()
    assert _streams(orch) == jax_solo_streams(jcfg, jp, rows)
    assert orch.dropped == 0


def test_respawned_group_is_readmitted_and_serves_a_pinned_request(
        tiny, servers):
    """``--supervise`` over group instances: a rank of w1 dies, its
    streams replay on w0, and the supervisor brings w1 back as
    ``w1~r1`` over a new store and group (the old store freed), holding
    the same weights on every rank; re-admitted, it serves a pinned
    sampled request to the reference's tokens."""
    jcfg, jp, tcfg, tp = tiny
    launch = servers.launcher(2)
    h0, h1 = (G.GroupInstance(tcfg, tp, width=2, launcher=launch,
                              label=f"w{i}", **KW) for i in range(2))
    assert h1.respawnable
    policy = RespawnPolicy(backoff_base=0.0, backoff_cap=0.0,
                           max_failures=3, window_s=10.0, start_timeout=30.0)
    orch = servers.own(Orchestrator(tcfg, None, handles=[h0, h1],
                                    telemetry_every=10_000,
                                    respawn_policy=policy))
    rows = _rows(4, 10)
    for s in specs(rows, jax_side=False):
        orch.submit_to(s.rid % 2, s)
    for _ in range(3):
        orch.step()
    port = h1._store.port
    h1.ranks[1].kill()
    orch.run_until_done()
    fresh = orch.instances[1]
    assert orch.faults.respawns == 1 and fresh is not h1
    assert fresh.label == "w1~r1"
    assert [r.peer_label for r in fresh.ranks] == ["w1~r1/r0", "w1~r1/r1"]
    assert [e["label"] for e in orch.respawn_log
            if e["event"] == "respawned"] == ["w1~r1"]
    assert h1._store is None and h1.exitcodes == [None, None]
    assert fresh._store.port != port
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
    sums = fresh._all("params_checksum")
    assert sums == [sums[0]] * 2 == h0._all("params_checksum")[:1] * 2
    post = _rows(1, 6, rid0=10, temperature=0.7, top_k=8)
    orch.submit_to(1, specs(post, jax_side=False)[0])
    orch.run_until_done()
    assert orch._home[10] == 1 and fresh.telemetry.total_finished == 1
    assert _streams(orch) == jax_solo_streams(jcfg, jp, rows + post)
    assert [r["rids"] for r in orch.recoveries] == [[1, 3]]
    assert orch.dropped == 0


def test_grown_group_takes_traffic_and_shrink_hands_off(tiny, servers):
    """``--elastic`` over group instances: the grouped worker factory
    grows the pod by a whole group ``g1`` that adopts the live plan and
    takes routed traffic; ``shrink_pod`` then drains it mid-decode onto
    w0 and retires it, every stream token-identical to the reference's."""
    jcfg, jp, tcfg, tp = tiny
    L = tcfg.num_layers
    factory = POD.make_worker_factory(tcfg, tp, width=2,
                                      launcher=servers.launcher(2), **KW)
    h0 = G.GroupInstance(tcfg, tp, width=2, launcher=servers.launcher(2),
                         label="w0", **KW)
    orch = servers.own(Orchestrator(
        tcfg, None, handles=[h0], worker_factory=factory,
        pod_cfg=PodElasticityConfig(max_instances=2, flap_guard_s=0.0),
        telemetry_every=10_000))
    rows = _rows(4, 8)
    first, *rest = specs(rows, jax_side=False)
    orch.submit(first)
    orch.step()
    orch._on_plan_change(types.SimpleNamespace(p=[2] * L), 2)
    assert orch.grow_pod() == 1 and orch.pod_size() == 2
    grown = orch.instances[1]
    assert grown.label == "g1" and grown.width == 2
    assert grown.pool_checks == 1   # the live plan, adopted
    d = orch.route(prompt=rest[0].prompt)
    assert d.idx == 1 and d.reason == "vacancy"
    for s in rest:
        orch.submit(s)
    for _ in range(3):
        orch.step()
    assert grown.active_rids()
    assert orch.shrink_pod(1) == 1
    assert 1 in orch._retired and grown.exitcodes == [None, None]
    orch.run_until_done()
    assert [e["event"] for e in orch.pod_log] == ["grow", "shrink"]
    assert orch.migrations and all(m.src == 1 for m in orch.migrations)
    assert _streams(orch) == jax_solo_streams(jcfg, jp, rows)
    assert orch.dropped == 0


def _free_ports(n):
    """The first port of ``n`` consecutive ports free on loopback."""
    for _ in range(50):
        base = int(TR.free_tcp_endpoint().rsplit(":", 1)[1])
        if base + n >= 65536:
            continue
        socks = []
        try:
            for k in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def test_launch_pod_groups_a_nodes_endpoints(tiny, servers):
    """An attach node of capacity 2 at width 2: ``launch_pod`` makes two
    group instances of two consecutive endpoints each, labelled in
    inventory order, that do not respawn (their servers are not ours);
    its store listens on every interface and is advertised on loopback;
    the two serve the reference's tokens."""
    jcfg, jp, tcfg, tp = tiny
    base = _free_ports(4)
    eps = servers.start([f"tcp://127.0.0.1:{base + k}" for k in range(4)])
    node = POD.Node("127.0.0.1", base, capacity=2, spawn=False)
    handles = POD.launch_pod(tcfg, tp, [node], width=2, **KW)
    orch = servers.own(Orchestrator(tcfg, None, handles=handles,
                                    telemetry_every=10_000))
    assert [h.label for h in handles] == ["w0", "w1"]
    assert [[r.endpoint for r in h.ranks] for h in handles] == [eps[:2],
                                                                eps[2:]]
    assert not any(h.respawnable for h in handles)
    assert handles[0].store_address == f"127.0.0.1:{handles[0]._store.port}"
    assert _listens_on_every_interface(handles[0]._store.port)
    rows = _rows(4, 6)
    for s in specs(rows, jax_side=False):
        orch.submit_to(s.rid % 2, s)
    orch.run_until_done()
    assert {h.telemetry.total_finished for h in handles} == {2}
    assert _streams(orch) == jax_solo_streams(jcfg, jp, rows)


def _listens_on_every_interface(port):
    """Whether a socket listens on ``port`` at the any-address (read from
    /proc/net/tcp and tcp6: state 0A)."""
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        with open(path) as f:
            for line in f.read().splitlines()[1:]:
                local, state = line.split()[1], line.split()[3]
                addr, hexport = local.split(":")
                if state == "0A" and int(hexport, 16) == port:
                    return set(addr) == {"0"}
    return False


@pytest.mark.parametrize("node,msg", [
    (POD.Node("127.0.0.1", 65535, capacity=1, spawn=False),
     r"node #0 \(127.0.0.1:65535\) cannot form 1 instances of 2 ranks"),
    (POD.Node("127.0.0.1", 0, capacity=1, spawn=False),
     r"node 127.0.0.1:\d+ \(attach\) could not form instance w0 of 2 ranks"),
])
def test_a_node_that_cannot_form_its_ranks_fails_naming_it(tiny, node, msg):
    """A node whose ports run out, or whose servers do not answer, fails
    the pod's bring-up with the node's name."""
    _, _, tcfg, tp = tiny
    if not node.port:   # nothing listens there
        node.port = _free_ports(2)
    with pytest.raises((ValueError, RuntimeError), match=msg):
        POD.launch_pod(tcfg, tp, [node], width=2, start_timeout=0.5, **KW)


@pytest.mark.parametrize("endpoint,loopback", [
    ("tcp://127.0.0.1:7101", True), ("tcp://localhost:7101", True),
    ("/tmp/repro-engine.sock", True), ("unix:///tmp/x.sock", True),
    ("tcp://10.0.0.7:7101", False), ("tcp://192.0.2.1:7101", False)])
def test_loopback_rule(endpoint, loopback):
    assert G.is_loopback(endpoint) is loopback


def test_store_is_advertised_at_the_nodes_way_back(tiny, servers,
                                                    monkeypatch):
    """A group whose ranks are not on loopback advertises its store as
    ``:port``, and each rank is told the local address of the connection
    over which the handle reached it; the group forms and serves. A
    loopback spec stays as it is."""
    _, _, tcfg, tp = tiny

    class Conn:
        def local_host(self):
            return "10.0.0.7"

    kw = {"device": "cpu", "group": {"store": ":4567", "rank": 1}}
    assert RE.advertise_store(kw, Conn())["group"] == {
        "store": "10.0.0.7:4567", "rank": 1}
    loop = {"group": {"store": "127.0.0.1:4567"}}
    assert RE.advertise_store(loop, Conn()) is loop
    assert RE.advertise_store({"device": "cpu"}, Conn()) == {"device": "cpu"}
    told = []
    join = RE.join_group
    monkeypatch.setattr(G, "is_loopback", lambda ep: False)
    monkeypatch.setattr(RE, "join_group",
                        lambda spec: told.append(spec["store"]) or join(spec))
    h = servers.own(G.GroupInstance(tcfg, tp, width=2,
                                    launcher=servers.launcher(2), **KW))
    assert h.store_address == f":{h._store.port}"
    assert told == [f"127.0.0.1:{h._store.port}"] * 2   # AF_UNIX: this host
    h.submit(specs(_rows(1, 3), jax_side=False)[0])
    while h.active_rids() or h.queue_len():
        h.step()


class _Fake(InstanceHandle):
    """Stands in for a GroupInstance in the wiring test: records how it
    was built."""
    made: list = []

    def __init__(self, cfg, params=None, **kw):
        self.params, self.kw = params, kw
        self.telemetry = EngineTelemetry()
        _Fake.made.append(self)

    def pool_bytes(self):
        return 1 << 20

    max_batch = 4
    bringup = [dict(connect_s=0.0, group_s=0.0, draw_s=0.0, broadcast_s=0.0)]

    def set_rpc_deadline(self, seconds):
        pass

    def close(self):
        pass


@pytest.mark.parametrize("flags,n", [
    (dict(workers=2), 2), (dict(supervise=True), 2),
    (dict(http=True, elastic=True, instances=1), 1),
    (dict(inventory="pod.toml"), 2)])
def test_serve_builds_group_instances_on_every_plane(tmp_path, monkeypatch,
                                                     flags, n):
    """With four cards visible, ``--workers``, ``--supervise``,
    ``--elastic`` and ``--inventory`` build handles of four ranks whose
    servers draw weights seed 0 (this process draws none), labelled
    ``w<k>``; the elastic factory builds ``g<idx>`` of four; an
    inventory node's instances take four consecutive endpoints each and
    spawn there; ``--supervise`` arms the respawn policy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(T, "init_params", None)
    monkeypatch.setattr(G, "GroupInstance", _Fake)
    monkeypatch.setattr(_Fake, "made", [])
    if "inventory" in flags:
        path = tmp_path / "pod.toml"
        path.write_text('[[node]]\nhost = "127.0.0.1"\nport = 7101\n'
                        'capacity = 2\n')
        flags = dict(flags, inventory=str(path))
    plane = S.build_plane(S.ServeConfig(device="cuda", **flags))
    orch = plane.orch
    assert plane.width == 4 and plane.n_instances == n
    assert [h.kw["label"] for h in orch.instances] == [f"w{k}"
                                                      for k in range(n)]
    for h in orch.instances:
        assert h.params is None and h.kw["width"] == 4
        assert h.kw["draw"] == {"seed": 0, "dtype": "float32"}
        assert h.kw["device"] == "cuda" and h.kw["max_len"] == S.SERVE_MAX_LEN
    assert (orch.respawn_policy is not None) == bool(flags.get("supervise"))
    if flags.get("elastic"):
        grown = orch.worker_factory(5)
        assert grown.kw["label"] == "g5" and grown.kw["width"] == 4
        assert grown.params is None and grown.kw["draw"]["seed"] == 0
        assert orch.pod_cfg.max_instances == 4
    else:
        assert orch.worker_factory is None
    if "inventory" in flags:
        assert [h.kw["endpoints"] for h in orch.instances] == [
            [f"tcp://127.0.0.1:{7101 + 4 * i + k}" for k in range(4)]
            for i in range(2)]
        assert all(h.kw["spawn"] for h in orch.instances)
    orch.close()
