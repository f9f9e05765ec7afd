"""Port parity, the pod launcher (``repro_torch.launch.pod``): inventory
parsing (TOML and JSON) and its rejections held to the reference's on
the same documents, the ``--show`` CLI, the pod bring-up deadline and
the reaping of spawned-but-unadopted children (a fake process context
and a slow proxy: no engine server), and the in-process worker factory.
A pod of two spawned port engine servers serving requests is tier 2
(``pytest.mark.slow``)."""
import json
import time

import numpy as np
import pytest

from repro.launch import pod as JPOD
from repro_torch.launch.pod import (Node, launch_pod, load_inventory, main,
                                    make_worker_factory, parse_inventory)
from repro_torch.serving import transport as TR
from repro_torch.serving.orchestrator import Orchestrator
from _torch_parity import jax_solo_streams, specs, tiny_pair
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import partitionable_threefry  # noqa: F401

TOML_DOC = """\
# two-machine pod: this host spawns, the second is attached
[[node]]
host = "127.0.0.1"
port = 7101
capacity = 2

[[node]]
host = "10.0.0.7"
port = 7201
capacity = 1
spawn = false
"""


def test_load_toml_and_json_inventory_match_reference(tmp_path):
    toml_path = tmp_path / "pod.toml"
    toml_path.write_text(TOML_DOC)
    json_path = tmp_path / "pod.json"
    json_path.write_text(json.dumps({"node": [
        {"host": "127.0.0.1", "port": 7301}]}))
    for path in (toml_path, json_path):
        nodes = load_inventory(str(path))
        ref = JPOD.load_inventory(str(path))
        assert [n.__dict__ for n in nodes] == [n.__dict__ for n in ref]
        assert [n.endpoints() for n in nodes] == [n.endpoints() for n in ref]
    nodes = load_inventory(str(toml_path))
    assert nodes[0].endpoints() == ["tcp://127.0.0.1:7101",
                                    "tcp://127.0.0.1:7102"]
    assert nodes[1] == Node(host="10.0.0.7", port=7201, capacity=1,
                            spawn=False)


@pytest.mark.parametrize("doc,msg", [
    ({}, "non-empty"),
    ({"node": []}, "non-empty"),
    ({"node": ["tcp://x:1"]}, "not a table"),
    ({"node": [{"host": "h"}]}, "port"),
    ({"node": [{"host": "h", "port": 1, "cap": 2}]}, "unknown keys"),
    ({"node": [{"host": "h", "port": 1, "capacity": 0}]}, "capacity"),
    ({"node": [{"host": "h", "port": 99999}]}, "out of range"),
    ({"node": [{"host": "h", "port": 7101, "capacity": 2},
               {"host": "h", "port": 7102}]}, "cannot share"),
])
def test_inventory_schema_rejections(doc, msg):
    """The port rejects what the reference rejects, with its message."""
    with pytest.raises(ValueError, match=msg) as got:
        parse_inventory(doc)
    with pytest.raises(ValueError) as ref:
        JPOD.parse_inventory(doc)
    assert str(got.value) == str(ref.value)


def test_show_cli_prints_expanded_endpoints(tmp_path, capsys):
    path = tmp_path / "pod.toml"
    path.write_text(TOML_DOC)
    assert main(["--show", str(path)]) == 0
    out = capsys.readouterr().out
    assert "tcp://127.0.0.1:7101  (spawn)" in out
    assert "tcp://127.0.0.1:7102  (spawn)" in out
    assert "tcp://10.0.0.7:7201  (attach)" in out


# ---------------------------------------------------- bring-up deadline
class _SlowProxy:
    """EngineProxy stand-in whose bring-up costs 0.15 s of wall time."""
    instances = []

    def __init__(self, cfg, params, *, endpoint, spawn, adopt_process,
                 start_timeout, peer_label, **kw):
        time.sleep(0.15)
        self.endpoint = endpoint
        self.peer_label = peer_label
        self.process = adopt_process
        self.start_timeout = start_timeout
        self.engine_kw = kw
        self.closed = False
        _SlowProxy.instances.append(self)

    def close(self):
        self.closed = True


class _FakeProc:
    """Records the lifecycle the reaper must drive."""
    _all = []

    def __init__(self, target=None, args=(), daemon=True):
        self.target, self.args = target, args
        self.started = self.killed = self.joined = False
        _FakeProc._all.append(self)

    def start(self):
        self.started = True

    def is_alive(self):
        return self.started and not self.killed

    def kill(self):
        self.killed = True

    def join(self, timeout=None):
        self.joined = True


class _FakeCtx:
    Process = _FakeProc


@pytest.fixture(autouse=True)
def _reset_fakes(monkeypatch):
    monkeypatch.setattr(_SlowProxy, "instances", [])
    monkeypatch.setattr(_FakeProc, "_all", [])


def test_pod_timeout_bounds_total_bring_up(monkeypatch):
    """``pod_timeout`` is a TOTAL deadline: slow endpoints fail the pod
    once it is spent, and every handle brought up before is closed."""
    monkeypatch.setattr("repro_torch.serving.remote_engine.EngineProxy",
                        _SlowProxy)
    nodes = [Node(host="127.0.0.1", port=7101, capacity=4, spawn=False)]
    with pytest.raises(TR.TransportError, match="deadline"):
        launch_pod(None, None, nodes, pod_timeout=0.25)
    assert 0 < len(_SlowProxy.instances) < 4
    assert all(h.closed for h in _SlowProxy.instances)


def test_pod_budget_shrinks_and_engine_kw_reach_every_proxy(monkeypatch):
    """Each endpoint's budget is what remains of the pod deadline, the
    proxies are labeled w0..w3, and the engine kwargs (the device among
    them) reach each."""
    monkeypatch.setattr("repro_torch.serving.remote_engine.EngineProxy",
                        _SlowProxy)
    nodes = [Node(host="127.0.0.1", port=7101, capacity=4, spawn=False)]
    handles = launch_pod(None, None, nodes, pod_timeout=30.0, device="cpu",
                         max_batch=2)
    assert [h.peer_label for h in handles] == ["w0", "w1", "w2", "w3"]
    budgets = [h.start_timeout for h in handles]
    assert all(b > a for a, b in zip(budgets[1:], budgets))
    assert all(h.engine_kw == {"device": "cpu", "max_batch": 2}
               for h in handles)
    assert not any(h.closed for h in handles)


def test_pod_deadline_reaps_spawned_but_unadopted_children(monkeypatch):
    """When the pod deadline fires mid-launch, server processes spawned
    in phase one but never adopted are killed and joined; adopted ones
    are left to their (closed) handles."""
    monkeypatch.setattr("repro_torch.serving.remote_engine.EngineProxy",
                        _SlowProxy)
    monkeypatch.setattr("multiprocessing.get_context",
                        lambda method: _FakeCtx)
    from repro_torch.serving.remote_engine import engine_server_listen
    nodes = [Node(host="127.0.0.1", port=7101, capacity=4, spawn=True)]
    with pytest.raises(TR.TransportError, match="deadline"):
        launch_pod(None, None, nodes, pod_timeout=0.25)
    assert len(_FakeProc._all) == 4
    assert all(p.started and p.target is engine_server_listen
               for p in _FakeProc._all)
    assert [p.args for p in _FakeProc._all] == [
        (f"tcp://127.0.0.1:{7101 + k}",) for k in range(4)]
    adopted = {id(h.process) for h in _SlowProxy.instances}
    assert adopted and len(adopted) < 4
    reaped = [p for p in _FakeProc._all if id(p) not in adopted]
    assert reaped and all(p.killed and p.joined for p in reaped)
    assert not any(p.killed for p in _FakeProc._all if id(p) in adopted)


# ------------------------------------------------------- worker factory
@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


ENG_KW = dict(max_batch=2, max_len=64, block_size=8, device="cpu")


def test_worker_factory_builds_local_paged_instances(tiny):
    _, _, tcfg, tp = tiny
    h = make_worker_factory(tcfg, tp, **ENG_KW)(0)
    try:
        assert h.block_size == 8 and h.engine.device.type == "cpu"
        assert h.free_blocks() > 0 and h.alive()
        assert h.prefix_keys() == set()
    finally:
        h.close()


# ------------------------------------------ tier 2: a spawned TCP pod
@pytest.mark.slow
@pytest.mark.usefixtures("partitionable_threefry")
def test_spawned_pod_serves_token_identically(tiny):
    """Two spawned port engine servers listening at free inventory
    endpoints, driven by the orchestrator over TCP: every stream equals
    the JAX package's, nothing dropped, no server outlives close()."""
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(5)
    rows = [(i, rng.integers(2, tcfg.vocab_size, size=9).astype(np.int32),
             8, 0.7 if i % 2 else 0.0, 8 if i % 2 else 0, 3 + i)
            for i in range(4)]
    ref = jax_solo_streams(jcfg, jp, rows)
    ports = [int(TR.free_tcp_endpoint().rsplit(":", 1)[1]) for _ in range(2)]
    nodes = [Node(host="127.0.0.1", port=p, capacity=1) for p in ports]
    handles = launch_pod(tcfg, tp, nodes, pod_timeout=120, **ENG_KW)
    procs = [h.process for h in handles]
    orch = Orchestrator(tcfg, tp, handles=handles, telemetry_every=10_000)
    try:
        assert [h.peer_label for h in handles] == ["w0", "w1"]
        for s in specs(rows, jax_side=False):
            orch.submit(s)
        orch.run_until_done()
        assert {r.rid: r.generated for r in orch.finished} == ref
        assert orch.dropped == 0
        assert orch.control_plane_stats()["rpc_polls_per_tick"] == 1.0
    finally:
        orch.close()
    assert [p.exitcode for p in procs] == [0, 0]
