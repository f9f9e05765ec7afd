"""Port parity, one serving instance over a replication group on the CPU
(``serving.group.GroupInstance``): each rank's engine server runs on a
thread of this process behind a real AF_UNIX connection, the ranks of a
group joined over gloo through the handle's ``TCPStore``; no process is
spawned. Two instances of 2 ranks under the port's Orchestrator give the
streams of the reference's Orchestrator on the same bridged weights and
requests across mid-decode plans and a drain; every step's tokens agree
on every rank, the pools stay bit-equal after every plan and move, and
the all-gathers are those the hooks predict; a rank that disagrees
raises, a rank that dies fails its whole instance and its streams finish
on the other; weights drawn by seed in a server equal an in-process
draw; the width rule follows the reference's mesh."""
import threading
import types

import numpy as np
import pytest
import torch

from repro.serving.orchestrator import Orchestrator as JaxOrchestrator
from repro_torch.models import transformer as T
from repro_torch.serving import instrument as INS
from repro_torch.serving import remote_engine as RE
from repro_torch.serving import transport as TR
from repro_torch.serving.group import GroupInstance, GroupMismatch, host_width
from repro_torch.serving.orchestrator import Orchestrator
from _torch_parity import jax_solo_streams, specs, tiny_pair
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import partitionable_threefry  # noqa: F401

pytestmark = pytest.mark.usefixtures("partitionable_threefry")
SAMPLINGS = [(0.0, 0), (0.8, 16)]
KW = dict(max_batch=4, max_len=64, block_size=8, n_blocks=24, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


class _Group:
    """W engine servers, each on a thread listening at a fresh AF_UNIX
    path, and the GroupInstance attached to them."""

    def __init__(self, cfg, params=None, width=2, **kw):
        n = torch.get_num_threads()
        addrs = [TR.listener_address() for _ in range(width)]
        self.errors = []
        self.threads = [threading.Thread(target=self._run, args=(a, n),
                                         daemon=True) for a in addrs]
        for t in self.threads:
            t.start()
        self.handle = GroupInstance(cfg, params, width=width,
                                    endpoints=addrs, **dict(KW, **kw))

    def _run(self, addr, n):
        torch.set_num_threads(n)   # every rank at the caller's count
        try:
            RE.engine_server_listen(addr)
        except Exception as e:  # noqa: BLE001 - read by the test
            self.errors.append(e)

    def close(self):
        self.handle.close()
        for t in self.threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in self.threads)


@pytest.fixture
def groups():
    made = []

    def make(cfg, params=None, **kw):
        g = _Group(cfg, params, **kw)
        made.append(g)
        return g.handle

    yield make
    for g in made:
        g.close()


def _rows(n, max_tokens, temperature=0.0, top_k=0):
    return [(i, np.arange(2 + i, 12 + 2 * i, dtype=np.int32), max_tokens,
             temperature, top_k, 7 + i) for i in range(n)]


def predicted_gathers(degrees):
    """One all-gather per replicated layer (its K/V rows) and one where a
    run of layers of one degree above 1 ends."""
    n, cur = sum(d > 1 for d in degrees), 1
    for d in (*degrees, 1):
        n += cur > 1 and d != cur
        cur = d
    return n


def _script(orch, rows, L):
    """Rows admitted alternately on the two instances, a mixed plan and
    then degree 2 everywhere applied mid-decode, then instance 1
    drained. Returns (streams, migrated rids)."""
    for s in specs(rows, jax_side=isinstance(orch, JaxOrchestrator)):
        orch.submit_to(s.rid % 2, s)
    plans = {2: [2] + [1] * (L - 1), 4: [2] * L}
    for i in range(6):
        if i in plans:
            orch._on_plan_change(types.SimpleNamespace(p=plans[i]), 2)
        orch.step()
    orch.drain_instance(1)
    orch.run_until_done()
    return ({r.rid: list(r.generated) for r in orch.finished},
            {m.rid for m in orch.migrations})


@pytest.mark.parametrize("temperature,top_k", SAMPLINGS)
def test_two_groups_match_reference_orchestrator(tiny, groups, temperature,
                                                 top_k):
    """Two instances of 2 ranks under the port's Orchestrator against the
    reference's Orchestrator, same weights, requests and script: streams
    and migrated streams token-identical. On every rank of both
    instances: the tokens agreed at every step (the handle raises
    otherwise), the pools were held bit-equal after every plan and move,
    every import read back bit-equal, and each replicated decode step ran
    the all-gathers the hooks predict."""
    jcfg, jp, tcfg, tp = tiny
    L = tcfg.num_layers
    rows = _rows(4, 12, temperature, top_k)
    jorch = JaxOrchestrator(jcfg, jp, n_instances=2, max_batch=4,
                            max_len=64, block_size=8, n_blocks=24,
                            telemetry_every=10_000)
    ref, ref_moved = _script(jorch, rows, L)
    handles = [groups(tcfg, tp) for _ in range(2)]
    orch = Orchestrator(tcfg, None, handles=handles, telemetry_every=10_000)
    got, moved = _script(orch, rows, L)
    assert got == ref
    assert moved == ref_moved and moved
    assert all(m.resumed for m in orch.migrations)
    assert orch.dropped == 0
    for h in handles:
        assert h.pool_checks >= 2 and h.step_logs
        sums = h._all("pool_checksum")
        assert sums[0] == sums[1]
        replicated = [s for s in h.step_logs
                      if s[0]["decode"] and s[0]["degrees"]]
        assert replicated
        for step in replicated:
            for log in step:
                assert log["gathers"] == predicted_gathers(log["degrees"])
    assert handles[0].read_backs >= 2 * len(moved)


def test_disagreeing_rank_raises(tiny, groups):
    """A request that reaches rank 1 alone leaves the ranks' queues
    apart: the next fanned-out call raises, naming rank 1; a step reply
    whose stream differs on rank 1 raises, naming the rid."""
    _, _, tcfg, tp = tiny
    h = groups(tcfg, tp)
    s0, s1, s2 = specs(_rows(3, 4), jax_side=False)
    h.submit(s0)
    replies = h.step_async().wait()
    bad = [replies[0], dict(replies[1], streams={
        rid: toks + [1] for rid, toks in replies[1]["streams"].items()})]
    with pytest.raises(GroupMismatch, match=r"rank 1's rid 0"):
        h.finish_step(bad)
    h.ranks[1].submit(s1)
    with pytest.raises(GroupMismatch, match="rank 1"):
        h.submit(s2)


def test_dead_rank_fails_its_instance(tiny, groups):
    """Rank 1 of instance 0 loses its connection mid-decode: the whole
    instance is dead (rank 0 severed too), and its streams replay on
    instance 1 to the reference's tokens."""
    jcfg, jp, tcfg, tp = tiny
    rows = _rows(4, 10)
    handles = [groups(tcfg, tp) for _ in range(2)]
    orch = Orchestrator(tcfg, None, handles=handles, telemetry_every=10_000)
    for s in specs(rows, jax_side=False):
        orch.submit_to(s.rid % 2, s)
    for _ in range(3):
        orch.step()
    handles[0].ranks[1].kill()
    assert not handles[0].alive()
    orch.step()
    orch.run_until_done()
    assert not handles[0].ranks[0].alive()
    assert [r["instance"] for r in orch.recoveries] == [0]
    assert set(orch.recoveries[0]["rids"]) == {0, 2}
    assert {r.rid: r.generated for r in orch.finished} == \
        jax_solo_streams(jcfg, jp, rows)


@pytest.mark.parametrize("width", [1, 2])
def test_weights_by_seed_equal_an_in_process_draw(tiny, groups, width):
    """A server asked for a draw holds ``init_params`` of that seed bit
    for bit, on every rank (rank 0 draws, the broadcast replicates)."""
    _, _, tcfg, _ = tiny
    h = groups(tcfg, draw={"seed": 3, "dtype": "float32"}, width=width)
    want = [INS.bits_checksum(t) for _, t in RE._leaves(
        T.init_params(tcfg, torch.Generator("cpu").manual_seed(3),
                      "float32"))]
    assert h._all("params_checksum") == [want] * width
    assert all(b["weight_bytes"] == 0 for b in h.bringup)


@pytest.mark.parametrize("device,count,width", [
    ("cuda", 1, 1), ("cuda", 2, 2), ("cuda", 3, 2), ("cuda", 4, 4),
    ("cuda", 8, 8), ("cuda", 0, 1), ("cpu", 4, 1), ("cpu", 0, 1)])
def test_width_rule(device, count, width):
    """An instance spans the largest power of two of the visible cards,
    as the reference's replication mesh does; one rank on the CPU."""
    assert host_width(device, count) == width


def test_group_needs_power_of_two_and_one_source_of_weights(tiny):
    _, _, tcfg, tp = tiny
    with pytest.raises(ValueError, match="power-of-two"):
        GroupInstance(tcfg, tp, width=3, **KW)
    with pytest.raises(ValueError, match="params or as a draw"):
        GroupInstance(tcfg, tp, width=2, draw={"seed": 0,
                                                "dtype": "float32"}, **KW)
