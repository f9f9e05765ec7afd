"""Port parity, the remote serving plane on the CPU: the port's
``EngineServer`` behind a real transport connection (a loopback listener
served from a thread of this process), driven by ``EngineProxy``.
Streams through the server are held against the JAX package's engine;
migrations over the wire keep every block bit-equal on the ``"bits"``
and ``"float32"`` wires; a port server's ``"float32"`` payload resumes
on the reference's ``EngineServer``; the weight init stream splits
stacked tensors under a small frame bound and rebuilds the tree bit for
bit; a server asked for CUDA without a card raises.

One test here spawns a real engine-server process (dial-back, on the
CPU). Tests with two or more spawned servers carry ``pytest.mark.slow``
(tier 2, ``pytest -m slow``), as the reference's
``tests/test_distributed_plane.py`` does."""
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.remote_engine import EngineServer as JaxEngineServer
from repro_torch.serving import remote_engine as RE
from repro_torch.serving import transport as TR
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.orchestrator import Orchestrator
from _torch_parity import jax_solo_streams, specs, tiny_pair
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import partitionable_threefry  # noqa: F401

pytestmark = pytest.mark.usefixtures("partitionable_threefry")
SAMPLINGS = [(0.0, 0), (0.8, 16)]
KW = dict(max_batch=2, max_len=64, block_size=8, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


def _leaves(tree, prefix=()):
    """(path, tensor) of every leaf of a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


class _Served:
    """An engine server in a thread of this process, listening on a
    fresh AF_UNIX path, and the proxy attached to it."""

    def __init__(self, cfg, params, **kw):
        addr = TR.listener_address()
        self.error = None
        self.thread = threading.Thread(target=self._run, args=(addr,),
                                       daemon=True)
        self.thread.start()
        self.proxy = RE.EngineProxy(cfg, params, endpoint=addr, spawn=False,
                                    **kw)

    def _run(self, addr):
        try:
            RE.engine_server_listen(addr)
        except Exception as e:  # noqa: BLE001 - read by the test
            self.error = e

    def close(self):
        self.proxy.close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture
def served():
    made = []

    def make(cfg, params, **kw):
        s = _Served(cfg, params, **dict(KW, **kw))
        made.append(s)
        return s.proxy

    yield make
    for s in made:
        s.close()


def _rows(n, max_tokens, temperature=0.0, top_k=0):
    return [(i, np.arange(2 + i, 12 + i, dtype=np.int32), max_tokens,
             temperature, top_k, 7 + i) for i in range(n)]


def _run(proxy):
    done = []
    while proxy.queue_len() or proxy.active_rids():
        done += proxy.step()
    return {r.rid: r.generated for r in done}


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("temperature,top_k", SAMPLINGS)
def test_server_streams_match_reference(tiny, served, temperature, top_k):
    """Greedy and sampled requests through the server: the streams equal
    the JAX package's engine on the same inputs, and the server's info
    reports its process, device and one host sync per steady step."""
    jcfg, jp, tcfg, tp = tiny
    rows = _rows(2, 8, temperature, top_k)
    ref = jax_solo_streams(jcfg, jp, rows)
    proxy = served(tcfg, tp)
    for s in specs(rows, jax_side=False):
        proxy.submit(s)
    assert _run(proxy) == ref
    info = proxy.info()
    assert info["pid"] == os.getpid() and info["device"] == "cpu"
    assert info["decode_steps"] > 0 and set(info["steady_syncs"]) == {"1"}
    med, lo, hi, n = info["steady_ms"]
    assert 0 < lo <= med <= hi and n == info["steady_syncs"]["1"]
    assert proxy.bringup["weight_bytes"] == sum(
        t.numel() * t.element_size() for _, t in _leaves(tp))


def _slot_bits(proxy, rid):
    """rid's live blocks on ``proxy``'s server, as the "bits" wire reads
    them back: (cols, k, v)."""
    slot = {r: s for s, r in proxy.active_rids().items()}[rid]
    wire, proxy.wire = proxy.wire, "bits"
    try:
        kv = proxy.snapshot_request(slot)["kv"]
    finally:
        proxy.wire = wire
    return list(kv["cols"]), kv["k"], kv["v"]


@pytest.mark.parametrize("wire", ["bits", "float32"])
@pytest.mark.parametrize("mode", ["stw", "two-phase"])
def test_migration_over_the_wire_bit_equal(tiny, served, mode, wire):
    """A bf16 pool's blocks moved between two servers, stop-the-world or
    two-phase, on either wire: the destination holds every block bit for
    bit as the source held it at the pause, and the streams equal an
    unmigrated port engine with the same max_batch."""
    _, _, tcfg, tp = tiny
    tp16 = _bf16(tp)
    rows = _rows(2, 12, 0.8, 16)
    solo = Engine(tcfg, tp16, dtype="bfloat16", **KW)
    for s in specs(rows, jax_side=False):
        solo.submit(s)
    ref = {r.rid: r.generated for r in solo.run_until_done()}
    a = served(tcfg, tp16, dtype="bfloat16", wire=wire)
    b = served(tcfg, tp16, dtype="bfloat16")
    for s in specs(rows, jax_side=False):
        a.submit(s)
    for _ in range(4):
        a.step()
    done = {}
    for rid in (0, 1):
        slot = {r: s for s, r in a.active_rids().items()}[rid]
        if mode == "stw":
            want = _slot_bits(a, rid)
            payload = a.pause_request(slot)
            assert b.resume_request(payload)
        else:
            snap = a.snapshot_request(slot)
            stage = b.prepare_resume_async(snap)
            staged = stage.wait()
            for r in a.step():          # the source decodes meanwhile
                done[r.rid] = r.generated
            want = _slot_bits(a, rid)
            payload = a.pause_request(slot, since_epoch=snap["epoch"])
            assert len(payload["kv"]["cols"]) < len(want[0])   # a delta
            assert b.commit_resume(staged, payload)
        kv = payload["kv"]
        assert kv.get("kv_dtype") == ("bfloat16" if wire == "bits" else None)
        assert kv["k"].dtype == (np.uint16 if wire == "bits" else np.float32)
        got = _slot_bits(b, rid)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    assert a.blocks_in_use() == 0 and not a.active_rids()
    done.update(_run(b))
    assert done == ref


def test_float32_payload_resumes_on_reference_server(tiny, served):
    """A port server's "float32" pause payload, resumed by the reference's
    EngineServer (in process), continues token-identically to the
    unmigrated JAX run."""
    jcfg, jp, tcfg, tp = tiny
    rows = _rows(1, 10, 0.8, 16)
    ref = jax_solo_streams(jcfg, jp, rows)
    a = served(tcfg, tp, wire="float32")
    a.submit(specs(rows, jax_side=False)[0])
    for _ in range(3):
        a.step()
    payload = a.pause_request(0)
    assert isinstance(payload["request"], Request)
    assert payload["kv"]["k"].dtype == np.float32
    jeng = JaxEngine(jcfg, jp, cache_kind="paged", max_batch=1, max_len=64,
                     block_size=8)
    server = JaxEngineServer(jeng)
    req = JaxRequest(**dataclasses.asdict(payload["request"]))
    assert server.resume_request(dict(payload, request=req))["result"]
    assert jeng.run_until_done()[0].generated == ref[0]


# ---------------------------------------------------------- init stream
def test_weight_stream_splits_under_a_small_bound(tiny):
    """With the receive bound at 256 KB, every stacked tensor over a
    quarter of it travels in several frames (whole layer slices where
    one fits), no frame passes the bound (the receiving connection would
    refuse it), and the tree arrives bit for bit, bf16 leaves as bits."""
    _, _, tcfg, tp = tiny
    tree = dict(tp, layers=_bf16(tp["layers"]))
    a, b = TR.socketpair()
    a.max_frame = b.max_frame = 1 << 18
    sent = {}
    th = threading.Thread(
        target=lambda: sent.update(n=RE.send_init(a, tcfg, tree, KW)))
    th.start()
    header = b.recv()
    frames = []

    def read():
        for _ in range(header["frames"]):
            frames.append(b.recv())
            yield frames[-1]

    got = RE.receive_weights(header, read())
    th.join(timeout=30)
    leaves = dict(_leaves(tree))
    assert header["engine_kw"] == KW and header["cfg"] == tcfg
    assert len(frames) > len(leaves)
    assert sent["n"] == sum(t.numel() * t.element_size()
                            for t in leaves.values())
    budget = a.max_frame // 4
    by_path = {}
    for f in frames:
        by_path.setdefault(tuple(f["path"]), []).append(f)
        assert f["data"].nbytes <= budget
    for path, t in leaves.items():
        fs = by_path[path]
        assert sum(f["data"].size for f in fs) == t.numel()
        row = t[0].numel() * t.element_size() if t.dim() else 0
        if t.numel() * t.element_size() > budget and 0 < row <= budget:
            assert len(fs) > 1
            assert all(f["data"].size % t[0].numel() == 0 for f in fs)
        assert all(f["dtype"] == str(t.dtype).removeprefix("torch.")
                   for f in fs)
    assert by_path[("layers", "mlp", "w_up")][0]["data"].dtype == np.uint16
    got = dict(_leaves(got))
    for path, t in leaves.items():
        g = got[path]
        assert g.dtype == t.dtype and g.shape == t.shape
        if t.dtype == torch.bfloat16:
            assert torch.equal(g.view(torch.int16), t.view(torch.int16))
        else:
            assert torch.equal(g, t)
    a.close()
    b.close()


@pytest.mark.parametrize("device", [None, "cuda"])
def test_server_without_a_card_raises(tiny, device):
    """A server asked for CUDA (named, or by default) in a process with no
    card answers the init with the error after reading the stream out:
    the proxy raises it, the server raises, nothing falls back to the
    CPU."""
    _, _, tcfg, tp = tiny
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    addr = TR.listener_address()
    box = {}

    def run():
        try:
            RE.engine_server_listen(addr)
        except RuntimeError as e:
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    kw = dict(KW, device=device) if device else {
        k: v for k, v in KW.items() if k != "device"}
    with pytest.raises(TR.RemoteError, match="no CUDA device"):
        RE.EngineProxy(tcfg, tp, endpoint=addr, spawn=False, **kw)
    th.join(timeout=30)
    assert "no CUDA device" in str(box["error"])


# ------------------------------------------------ one spawned server
def test_spawned_server_dial_back(tiny, monkeypatch):
    """The one tier-1 test that spawns: a dial-back engine-server process
    on the CPU serves a greedy and a sampled request token-identically
    to the JAX package, reports its own pid, and close() leaves no live
    child (exit code 0)."""
    jcfg, jp, tcfg, tp = tiny
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows = [_rows(1, 8)[0], _rows(2, 8, 0.8, 16)[1]]
    ref = jax_solo_streams(jcfg, jp, rows)
    proxy = RE.EngineProxy(tcfg, tp, **KW)
    try:
        assert proxy.process.pid != os.getpid()
        for s in specs(rows, jax_side=False):
            proxy.submit(s)
        assert _run(proxy) == ref
        assert proxy.info()["pid"] == proxy.process.pid
    finally:
        proxy.close()
    assert not proxy.process.is_alive()
    assert proxy.process.exitcode == 0


# ------------------------------------------------ tier 2: several spawns
def _reference_streams(jcfg, jp, n, max_tokens):
    rng = np.random.default_rng(3)
    rows = [(i, rng.integers(2, jcfg.vocab_size, size=8 + i % 4)
             .astype(np.int32), max_tokens,
             0.7 if i % 2 else 0.0, 8 if i % 2 else 0, 11 + i)
            for i in range(n)]
    return rows, jax_solo_streams(jcfg, jp, rows)


@pytest.mark.slow
def test_remote_orchestrator_scale_up_and_overlapped_drain(tiny):
    """Orchestrator(remote=True) on the CPU: two spawned port engine
    servers, a burst with live scale-up over the wire, then an
    overlapped drain; zero drops, every stream token-identical to the
    JAX package."""
    jcfg, jp, tcfg, tp = tiny
    rows, ref = _reference_streams(jcfg, jp, 8, 8)
    orch = Orchestrator(tcfg, tp, n_instances=2, max_batch=2, max_len=64,
                        block_size=8, n_blocks=32, slo_latency=30.0,
                        telemetry_every=2, remote=True, device="cpu")
    try:
        assert not orch.engines
        assert all(isinstance(h, RE.EngineProxy) for h in orch.instances)
        sp = specs(rows, jax_side=False)
        for s in sp[:6]:
            orch.submit(s)
        for _ in range(12):
            orch.step()
        assert any(a.startswith("scale-up") for a in orch.controller.log)
        for s in sp[6:]:
            orch.submit(s)
        for _ in range(3):
            orch.step()
        src = max((0, 1), key=lambda i: orch.instances[i].active_count())
        if orch.instances[src].active_rids():
            recs = orch.drain_instance(src)
            assert recs and all(r.mode == "overlapped" for r in recs)
        orch.run_until_done()
        assert {r.rid: r.generated for r in orch.finished} == ref
        assert orch.dropped == 0
        procs = [h.process for h in orch.instances]
    finally:
        orch.close()
    assert not any(p.is_alive() for p in procs)


@pytest.mark.slow
def test_remote_crash_replays_and_respawns(tiny):
    """A spawned server killed mid-stream: its requests replay on the
    survivor token-identically, and respawn() brings up a fresh server
    that serves."""
    jcfg, jp, tcfg, tp = tiny
    rows, ref = _reference_streams(jcfg, jp, 4, 10)
    orch = Orchestrator(tcfg, tp, n_instances=2, max_batch=2, max_len=64,
                        block_size=8, telemetry_every=10_000, remote=True,
                        device="cpu")
    fresh = None
    try:
        for s in specs(rows, jax_side=False):
            orch.submit(s)
        for _ in range(3):
            orch.step()
        victim = orch.instances[1]
        victim.kill()
        orch.run_until_done()
        assert {r.rid: r.generated for r in orch.finished} == ref
        assert orch.dropped == 0 and orch.recoveries
        fresh = victim.respawn()
        fresh.submit(specs(rows[:1], jax_side=False)[0])
        assert _run(fresh) == {0: ref[0]}
    finally:
        orch.close()
        if fresh is not None:
            fresh.close()
