"""Port parity, the live module-scaling loop on the CPU: the port's
Orchestrator over two LocalInstances migrates live requests (stop-the-
world and two-phase), turns a controller scale-down into real block
transfers, iterates Alg. 2's phases in one control tick and applies
plans, every migrated stream token-identical to the unmigrated JAX run;
plus the copied controller, telemetry, router and transport held to the
reference on the same inputs."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.cluster import Cluster as JaxCluster
from repro.core.controller import Controller as JaxController
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.monitor import MetricsSnapshot as JaxSnapshot
from repro.core.monitor import Monitor as JaxMonitor
from repro.core.plan import PlacementPlan as JaxPlan
from repro.serving import router as JRT
from repro.serving.instrument import EngineTelemetry as JaxTelemetry
from repro_torch.bridge import params_from_numpy
from repro_torch.core import replication as R
from repro_torch.core.cluster import Cluster
from repro_torch.core.controller import Controller, ControllerConfig
from repro_torch.core.monitor import MetricsSnapshot, Monitor
from repro_torch.core.plan import PlacementPlan
from repro_torch.serving import router as RT
from repro_torch.serving import transport as TR
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.instance import LocalInstance
from repro_torch.serving.instrument import EngineTelemetry
from repro_torch.serving.orchestrator import Orchestrator
from repro_torch.serving.request import RequestSpec
from _torch_parity import jax_solo_streams, specs, tiny_pair
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import partitionable_threefry  # noqa: F401

pytestmark = pytest.mark.usefixtures("partitionable_threefry")
SAMPLINGS = [(0.0, 0), (0.8, 16)]


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


def _orch(tiny, **kw):
    _, _, tcfg, tp = tiny
    base = dict(n_instances=2, max_batch=2, max_len=64, block_size=8,
                n_blocks=24, telemetry_every=10_000, device="cpu")
    base.update(kw)
    return Orchestrator(tcfg, tp, **base)


def _rows(n, max_tokens, temperature=0.0, top_k=0):
    return [(i, np.arange(2 + i, 12 + i, dtype=np.int32), max_tokens,
             temperature, top_k, 7 + i) for i in range(n)]


def _on_instance0(orch, rows):
    """Force every request onto instance 0 (the migration source)."""
    reqs = []
    for s in specs(rows, jax_side=False):
        orch._home[s.rid] = 0
        reqs.append(orch.engines[0].submit(s))
    return reqs


# --------------------------------------------------- migration determinism
@pytest.mark.parametrize("temperature,top_k", SAMPLINGS)
def test_migration_token_identical(tiny, temperature, top_k):
    """Stop-the-world mid-stream from A to B: streams equal the
    unmigrated JAX run, A holds nothing, nothing dropped."""
    rows = _rows(2, 10, temperature, top_k)
    ref = jax_solo_streams(tiny[0], tiny[1], rows)
    orch = _orch(tiny)
    reqs = _on_instance0(orch, rows)
    for _ in range(4):
        orch.step()
    assert all(len(r.generated) >= 2 for r in reqs)
    recs = orch.migrate_requests(0, 1)
    assert len(recs) == 2 and all(r.resumed for r in recs)
    assert all(r.mode == "stw" and r.bytes_moved > 0 for r in recs)
    assert not orch.engines[0].active
    assert orch.engines[0].pstate.blocks_in_use() == 0
    done = {r.rid: r.generated for r in orch.run_until_done()}
    assert done == ref
    assert orch.dropped == 0


def test_migration_full_destination_replays(tiny):
    """A destination pool too small for the blocks re-queues the request
    there (never dropped); the replay is token-identical."""
    rows = [(0, np.arange(2, 18, dtype=np.int32), 8, 0.0, 0, 0)]
    ref = jax_solo_streams(tiny[0], tiny[1], rows)
    orch = _orch(tiny, max_batch=1)
    orch.engines[0].submit(specs(rows, jax_side=False)[0])
    for _ in range(3):
        orch.step()
    orch.engines[1].pstate.free = orch.engines[1].pstate.free[:1]
    recs = orch.migrate_requests(0, 1)
    assert len(recs) == 1 and not recs[0].resumed
    assert len(orch.engines[1].queue) == 1
    orch.engines[1].pstate.free = list(range(24))   # pool recovers
    done = {r.rid: r.generated for r in orch.run_until_done()}
    assert done == ref
    assert orch.dropped == 0


@pytest.mark.parametrize("temperature,top_k", SAMPLINGS)
def test_overlapped_migration_token_identical(tiny, temperature, top_k):
    """Two-phase: the victims decode on every overlap step (each gains
    exactly overlap_steps tokens), the phase-2 delta is shorter than the
    whole move, and the streams stay token-identical."""
    rows = _rows(2, 14, temperature, top_k)
    ref = jax_solo_streams(tiny[0], tiny[1], rows)
    orch = _orch(tiny)
    reqs = _on_instance0(orch, rows)
    for _ in range(4):
        orch.step()
    before = {r.rid: len(r.generated) for r in reqs}
    recs = orch.migrate_requests_overlapped(0, 1, overlap_steps=3)
    assert len(recs) == 2 and all(r.resumed for r in recs)
    assert all(r.mode == "overlapped" for r in recs)
    for r in reqs:
        assert len(r.generated) == before[r.rid] + 3
    assert all(r.delta_blocks >= 1 for r in recs)
    assert all(r.delta_bytes < r.bytes_moved for r in recs)
    assert not orch.engines[0].active
    assert orch.engines[0].pstate.blocks_in_use() == 0
    done = {r.rid: r.generated for r in orch.run_until_done()}
    assert done == ref
    assert orch.dropped == 0


def test_overlapped_migration_victim_finishes_during_overlap(tiny):
    """A victim that finishes at the source between the phases aborts
    its staging: nothing moves, leaks or drops."""
    orch = _orch(tiny, max_batch=1)
    req = orch.engines[0].submit(
        RequestSpec(rid=0, prompt=np.arange(2, 10, dtype=np.int32),
                    max_tokens=4))
    orch.step()
    ticket = orch.begin_migration(0, 1, req.slot)
    for _ in range(6):
        orch.step()
    assert req.done
    assert orch.finish_migration(ticket) is None
    assert orch.engines[1].pstate.blocks_in_use() == 0
    assert not orch.engines[1]._staged
    assert orch.dropped == 0


def test_overlapped_migration_staging_failure_replays(tiny):
    """Staging finds no room: the finish falls back to pause + re-queue
    at the destination, and the replay is token-identical."""
    rows = [(0, np.arange(2, 18, dtype=np.int32), 8, 0.0, 0, 0)]
    ref = jax_solo_streams(tiny[0], tiny[1], rows)
    orch = _orch(tiny, max_batch=1)
    orch.engines[0].submit(specs(rows, jax_side=False)[0])
    for _ in range(3):
        orch.step()
    orch.engines[1].pstate.free = orch.engines[1].pstate.free[:1]
    recs = orch.migrate_requests_overlapped(0, 1)
    assert len(recs) == 1 and not recs[0].resumed
    assert len(orch.engines[1].queue) == 1
    orch.engines[1].pstate.free = list(range(24))
    done = {r.rid: r.generated for r in orch.run_until_done()}
    assert done == ref
    assert orch.dropped == 0


# ------------------------------------------------------------ control loop
def test_burst_scale_up_then_drain_scale_down(tiny):
    """Burst -> controller scale-up (the plan's degrees recorded on every
    live engine; one device, so each quantizes to 1) -> drain -> scale-
    down migration. Zero drops; every migrated stream token-identical."""
    _, _, tcfg, _ = tiny
    orch = _orch(tiny, n_blocks=32, slo_latency=30.0, telemetry_every=2)
    rng = np.random.default_rng(3)
    rows = [(i, rng.integers(2, tcfg.vocab_size, size=6 + i % 5)
             .astype(np.int32), 8, 0.0, 0, 0) for i in range(10)]
    sp = specs(rows, jax_side=False)
    for s in sp[:6]:
        orch.submit(s)
    for _ in range(12):
        orch.step()
    assert any(a.startswith("scale-up") for a in orch.controller.log)
    assert sum(orch.plan.p) > tcfg.num_layers
    for eng in orch.engines:
        assert eng.replication_degrees == tuple(orch.plan.p)
        assert eng._step_degrees == (1,) * tcfg.num_layers
    for s in sp[6:]:
        orch.submit(s)
    for _ in range(3):
        orch.step()
    src = max(range(2), key=lambda i: len(orch.engines[i].active))
    if orch.engines[src].active:
        assert orch.drain_instance(src)
        assert not orch.engines[src].active
    orch.run_until_done()
    assert {r.rid for r in orch.finished} == set(range(10))
    assert orch.dropped == 0
    migrated = {m.rid for m in orch.migrations}
    assert migrated
    ref = jax_solo_streams(tiny[0], tiny[1],
                           [r for r in rows if r[0] in migrated])
    got = {r.rid: r.generated for r in orch.finished}
    assert {rid: got[rid] for rid in migrated} == ref


def _violating(orch):
    orch.controller.observe(MetricsSnapshot(
        t=orch.engines[0].clock, slo_violation_rate=1.0,
        device_util=[1.0, 0.0], device_mem_frac=[0.9, 0.0],
        block_vacancy=[0.1, 1.0]))


def test_controller_scale_down_triggers_block_migration(tiny):
    """A violation snapshot drives Controller -> ScaleDownResult
    .migrations -> real block transfers off instance 0."""
    rows = [(0, np.arange(2, 10, dtype=np.int32), 16, 0.0, 0, 0)]
    ref = jax_solo_streams(tiny[0], tiny[1], rows)
    orch = _orch(tiny, n_blocks=32, slo_latency=5.0)
    _on_instance0(orch, rows)
    for _ in range(3):
        orch.step()
    _violating(orch)
    action = orch.controller.tick()
    assert action and action.startswith("scale-down")
    assert orch.controller.last_scale_down.migrations
    assert orch._execute_scale_down() == 1
    assert orch.migrations and orch.migrations[0].src == 0
    assert len(orch.engines[1].active) == 1
    assert orch.engines[0].pstate.blocks_in_use() == 0
    done = orch.run_until_done()
    assert {r.rid: r.generated for r in done} == ref
    assert orch.dropped == 0


def test_control_tick_iterates_scale_down_phases(tiny):
    """Alg. 2 feedback within one burst: post-action snapshots are fed
    back and further phases run in the same control_tick; the cooldown
    is armed once."""
    orch = _orch(tiny, max_batch=4, n_blocks=32, slo_latency=1e-9,
                 max_phases=3)
    _on_instance0(orch, [(i, np.arange(2, 10, dtype=np.int32), n, 0.0, 0,
                          0) for i, n in enumerate((2, 2, 30, 30))])
    for _ in range(5):
        orch.step()
    assert any(r.done for r in orch.finished)
    assert orch.engines[0].active
    hist0, log0 = len(orch.monitor.history), len(orch.controller.log)
    action = orch.control_tick()
    assert action and action.startswith("scale-down")
    n_obs = len(orch.monitor.history) - hist0
    n_actions = len(orch.controller.log) - log0
    assert n_obs >= 2
    assert n_actions == n_obs or n_obs == orch.max_phases
    assert orch.controller._cooldown == orch.controller.cfg.cooldown_ticks
    orch.run_until_done()
    assert {r.rid for r in orch.finished} == {0, 1, 2, 3}
    assert orch.dropped == 0


def test_control_tick_burst_stops_when_nothing_moves(tiny):
    """A scale-down that migrates nothing ends the burst after one
    phase."""
    orch = _orch(tiny, n_blocks=32, slo_latency=1e-9)
    orch.submit(RequestSpec(rid=0, prompt=np.arange(2, 10, dtype=np.int32),
                            max_tokens=2))
    orch.run_until_done()
    hist0 = len(orch.monitor.history)
    if orch.control_tick() is not None:
        assert len(orch.monitor.history) - hist0 == 1
    assert orch.dropped == 0


def test_apply_plan_is_token_invariant(tiny, monkeypatch):
    """Mixed degrees, then the all-ones plan, mid-decode: the stream is
    the unmigrated reference's. Without a replication group every degree
    quantizes to 1; in a group of 2 the mixed plan keeps its degrees
    (the replicated steps: tests/test_torch_replication.py)."""
    _, _, tcfg, tp = tiny
    rows = [(0, np.arange(2, 10, dtype=np.int32), 10, 0.0, 0, 0)]
    ref = jax_solo_streams(tiny[0], tiny[1], rows)
    e = Engine(tcfg, tp, device="cpu", max_batch=1, max_len=64,
               block_size=8)
    e.submit(specs(rows, jax_side=False)[0])
    mixed = [1 + i % 3 for i in range(tcfg.num_layers)]
    out = []
    for i in range(40):
        if i == 3:
            e.apply_plan(mixed)
            assert e._step_degrees == (1,) * tcfg.num_layers
        if i == 6:
            e.apply_plan(PlacementPlan.initial(tcfg.num_layers))
            assert e._step_degrees is None
        out += e.step() or []
        if not (e.queue or e.active):
            break
    assert out[0].generated == ref[0]
    assert e.replication_degrees == (1,) * tcfg.num_layers
    monkeypatch.setattr(e, "group", R.ReplicationGroup(object(), 0, 2, "cpu"))
    e.apply_plan(mixed)
    assert e.replication_degrees == tuple(mixed)
    assert e._step_degrees == tuple(min(d, 2) for d in mixed)
    with pytest.raises(ValueError):
        e.apply_plan([2])


class _ProxyRecorder(LocalInstance):
    """Stands in for ``remote_engine.EngineProxy``: records the keywords
    the remote branch passes and serves from an in-process engine."""
    calls = []

    def __init__(self, cfg, params, **kw):
        _ProxyRecorder.calls.append(kw)
        super().__init__(Engine(cfg, params, cache_kind="paged", **kw))


def test_device_and_remote_rules(tiny, monkeypatch):
    """No device and no CUDA: the orchestrator refuses. ``remote=True``
    builds one ``EngineProxy`` per instance, the engine settings and the
    device passed to each."""
    _, _, tcfg, tp = tiny
    assert R.default_replication_group("cpu").size == 1
    monkeypatch.setattr("repro_torch.serving.remote_engine.EngineProxy",
                        _ProxyRecorder)
    monkeypatch.setattr(_ProxyRecorder, "calls", [])
    orch = Orchestrator(tcfg, tp, remote=True, device="cpu", max_len=64,
                        n_instances=2)
    assert [type(h) for h in orch.instances] == [_ProxyRecorder] * 2
    assert _ProxyRecorder.calls == [dict(
        max_batch=4, max_len=64, dtype="float32", block_size=16,
        n_blocks=None, device="cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Orchestrator(tcfg, tp, max_len=64)


def test_local_instance_surface(tiny):
    """The handle's gauges read the engine; an explicit handles=[...]
    list is taken as the pod."""
    _, _, tcfg, tp = tiny
    engines = [Engine(tcfg, tp, device="cpu", max_batch=2, max_len=64,
                      block_size=8) for _ in range(2)]
    orch = Orchestrator(tcfg, tp, handles=[LocalInstance(e)
                                           for e in engines],
                        telemetry_every=10_000)
    assert orch.engines == engines
    orch.submit(RequestSpec(rid=5, prompt=np.arange(2, 19, dtype=np.int32),
                            max_tokens=3))
    orch.step()
    e = engines[orch._home[5]]
    h = orch.instances[orch._home[5]]
    assert h.active_rids() == e.slot_rids() == {0: 5}
    assert h.blocks_in_use() == e.pstate.blocks_in_use() > 0
    assert h.free_blocks() + h.blocks_in_use() == h.n_blocks
    assert h.pool_bytes() == e.pstate.pool_bytes()
    assert h.block_size == 8 and len(h.prefix_keys()) == 2
    assert h.stream_view() == {5: e.active[0].generated}
    assert h.set_token_budget(64) == 64 == e.sched.token_budget
    assert h.telemetry.total_tokens > 0
    orch.run_until_done()
    assert orch.stats()["finished"] == 1 and orch.dropped == 0


# --------------------------------------------------- copies vs reference
def _record(tel):
    tel.record_step(0.01, 3, packed=5, budget=8)
    tel.record_step(0.03, 2, packed=8, budget=8)
    tel.record_prefix(10, 4, 2)
    tel.record_preemptions(1)
    for i, slo in enumerate(("interactive", "batch", "interactive")):
        tel.record_finished([dataclasses.replace(
            Request(rid=i, prompt=np.zeros(2, np.int32)),
            submit_time=1.0, first_token_time=2.0 + i,
            finish_time=9.0 + i, prefill_start_time=1.5,
            generated=[1, 2, 3], slo_class=slo)])


def test_telemetry_matches_reference():
    """EngineTelemetry on the same records: the same serialized state
    and gauges as the reference's, and a lossless round trip."""
    t, j = EngineTelemetry(window=4), JaxTelemetry(window=4)
    _record(t)
    _record(j)
    assert t.to_state() == j.to_state()
    for g in ("tokens_per_s", "mean_step_s", "budget_utilization",
              "prefix_hit_rate"):
        assert getattr(t, g)() == getattr(j, g)()
    assert t.slo_violation_rate(8.5) == j.slo_violation_rate(8.5)
    u = EngineTelemetry()
    u.load_state(t.to_state())
    assert u.to_state() == t.to_state()
    assert set(t.to_state()) == set(vars(t)) | {"window"}


SNAPS = [
    dict(slo_violation_rate=1.0, device_util=[1.0, 0.0],
         device_mem_frac=[0.9, 0.0], block_vacancy=[0.1, 1.0]),
    dict(device_util=[0.1, 0.1], device_mem_frac=[0.1, 0.1],
         block_vacancy=[0.9, 0.9]),
    dict(queue_len=3, device_util=[0.6, 0.2], device_mem_frac=[0.97, 0.3],
         block_vacancy=[0.03, 0.7], preemptions=2),
]


@pytest.mark.parametrize("snap", SNAPS, ids=["violation", "vacant",
                                              "pressure"])
def test_controller_matches_reference(tiny, snap):
    """The copied controller (Alg. 1 / Alg. 2 over the copied cluster,
    plan, speedup and monitor) decides as the reference does on the same
    snapshots: the same log, plan and scale-down migrations."""
    jcfg, tcfg = tiny[0], tiny[2]

    def run(cluster, plan, ctl_cls, cfg_cls, mon, snap_cls, mcfg):
        ctl = ctl_cls(cfg_cls(replica_size=1e8), cluster,
                      plan.initial(mcfg.num_layers), mon, batch_size=4)
        for t in range(3):
            ctl.observe(snap_cls(t=float(t), **snap))
            ctl.tick()
        sd = ctl.last_scale_down
        return (ctl.log, list(ctl.plan.p), ctl.batch_size,
                sd and [tuple(m) for m in sd.migrations])

    port = run(Cluster.homogeneous(2), PlacementPlan, Controller,
               ControllerConfig, Monitor(), MetricsSnapshot, tcfg)
    ref = run(JaxCluster.homogeneous(2), JaxPlan, JaxController,
              JaxControllerConfig, JaxMonitor(), JaxSnapshot, jcfg)
    assert port == ref
    assert port[0]


def test_router_matches_reference(tiny):
    """Prefix-affinity keys are the reference's, byte for byte, so a pod
    routes a prompt to the same instance in both packages."""
    rng = np.random.default_rng(1)
    for n in (7, 16, 40):
        p = rng.integers(2, 256, n).astype(np.int32)
        assert RT.chain_hexkeys(p, 8) == JRT.chain_hexkeys(p, 8)


@pytest.mark.parametrize("codec", ["msgpack", "pickle"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transport_roundtrip_migration_payload(tiny, codec, dtype):
    """A port pause payload survives the wire (msgpack, and the pickle
    fallback a host without msgpack uses): the Request comes back as the
    port's, the blocks (bf16 as tagged bits) unchanged, and the decoded
    payload resumes on another engine."""
    _, jp, tcfg, tp = tiny
    if dtype == "bfloat16":
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                               torch.bfloat16)
    a, b = (Engine(tcfg, tp, device="cpu", max_batch=1, max_len=64,
                   block_size=8, dtype=dtype) for _ in range(2))
    a.submit(RequestSpec(rid=3, prompt=np.arange(2, 13, dtype=np.int32),
                         max_tokens=6))
    a.step()
    payload = a.pause_request(0)
    frame = TR.encode({"payload": payload,
                       "spec": RequestSpec.from_request(payload["request"])},
                      prefer=codec)
    assert frame[:1] == (TR.TAG_MSGPACK if codec == "msgpack"
                         else TR.TAG_PICKLE)
    got = TR.decode(frame)
    back, spec = got["payload"], got["spec"]
    assert type(back["request"]) is Request and type(spec) is RequestSpec
    assert dataclasses.asdict(back["request"]).keys() == \
        dataclasses.asdict(payload["request"]).keys()
    assert back["request"].generated == payload["request"].generated
    assert back["kv"].get("kv_dtype") == payload["kv"].get("kv_dtype")
    for k in ("k", "v", "cols"):
        assert back["kv"][k].dtype == payload["kv"][k].dtype
        np.testing.assert_array_equal(back["kv"][k], payload["kv"][k])
    assert b.resume_request(back)
    assert b.run_until_done()[0].generated[:2] == \
        payload["request"].generated
