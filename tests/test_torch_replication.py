"""Port parity, module replication across ranks on the CPU: a group of W
ranks runs as W threads of this process, each with its own
``ProcessGroupGloo`` over one shared ``HashStore`` (no process is
spawned). Held against the reference on the same inputs and weights:
the hooked forward against JAX's unconstrained forward (the reference's
``test_replicated_plan_matches_baseline``), the continuity property
(``test_continuity_reduces_collectives``), ``migrate_by_path``'s bytes
and values (``test_migration_moves_bytes_and_preserves_values``), and
``Engine.apply_plan`` changed mid-decode against the reference engine's
streams (``tests/test_orchestrator.py::test_apply_plan_is_token_invariant``),
the ranks' pools bit-equal."""
import dataclasses
import datetime
import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.core import migration as JM
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import migration as MIG
from repro_torch.core import replication as R
from repro_torch.core.plan import PlacementPlan
from repro_torch.models import transformer as T
from repro_torch.serving import paged_kv as PK
from repro_torch.serving.engine import Engine
from _torch_mesh import run_threads
from _torch_parity import MKL_CBWR_COMPATIBLE, jax_solo_streams, jit, mkl_branch, specs
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import partitionable_threefry  # noqa: F401

pytestmark = pytest.mark.usefixtures("partitionable_threefry")
ARCH = "tinyllama-1.1b"
_STORE = dist.HashStore()
_PREFIX = itertools.count()


def run_ranks(W, fn, timeout=120):
    """``fn(group)`` on W ranks, each a thread (``run_threads``) with its
    own gloo process group; returns the W results by rank and re-raises a
    rank's error."""
    prefix = f"g{next(_PREFIX)}"

    def rank(r):
        pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, _STORE), r, W,
                                   datetime.timedelta(seconds=timeout))
        return fn(R.ReplicationGroup.of(pg, "cpu"))

    return run_threads(W, rank, timeout)


def _pair(layers, arch=ARCH):
    """(jax cfg, jax params, port cfg, port params): ``arch.reduced()``
    at ``layers`` layers, fp32 weights from the reference's init."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), num_layers=layers)
    tcfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    jp = jit(JT.init_params, jcfg, jax.random.PRNGKey(0), "float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def tiny():
    return _pair(2)


@pytest.fixture(scope="module")
def tiny4():
    return _pair(4)


def test_mkl_runs_its_reproducible_branch():
    """The thread ranks' GEMMs run in MKL's reproducible mode: the
    ``MKL_CBWR=COMPATIBLE`` that ``_torch_parity`` sets before torch's
    first GEMM in this process took effect (ROADMAP C8)."""
    if mkl_branch() is None:
        pytest.skip("torch is built without MKL: no MKL branch to check")
    torch.ones(64, 64) @ torch.ones(64, 64)
    assert mkl_branch() == MKL_CBWR_COMPATIBLE


def test_group_axes_and_shards():
    """r0 is the rank's top bit; degree d splits over the first log2(d)
    axes; the size-1 group quantizes every degree to 1."""
    g = R.ReplicationGroup(object(), 5, 8, "cpu")
    assert g.axis_names == ("r0", "r1", "r2")
    assert [g.axis_index(a) for a in g.axis_names] == [1, 0, 1]
    assert [R.batch_shard_for_degree(d, g) for d in (1, 2, 4, 8)] == [
        (0, 1), (1, 2), (2, 4), (5, 8)]
    solo = R.default_replication_group()
    assert solo.size == 1 and solo.axis_names == ("r0",)
    assert R.quantize_degrees([1, 2, 3, 4, 8], solo.size) == [1] * 5
    assert R.quantize_degrees([1, 2, 3, 4, 8], 4) == [1, 2, 2, 4, 4]
    with pytest.raises(ValueError, match="power-of-two"):
        R.ReplicationGroup(object(), 0, 3, "cpu")


def test_same_device_resolves_the_current_card(tiny, monkeypatch):
    """A bare "cuda" and "cuda:<current index>" name one card, so an
    engine and its group may spell it either way; another index, or
    another type, is another device."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert R.same_device("cuda", "cuda:1")
    assert R.same_device(torch.device("cuda:1"), "cuda")
    assert not R.same_device("cuda", "cuda:0")
    assert not R.same_device("cuda:1", "cpu")
    assert R.same_device("cpu", torch.device("cpu"))
    _, _, tcfg, tp = tiny
    with pytest.raises(ValueError, match="device"):
        Engine(tcfg, tp, device="cpu",
               group=R.ReplicationGroup(object(), 0, 2, "cuda"))


@pytest.mark.parametrize("arch", [ARCH, "qwen2-moe-a2.7b"])
def test_replicated_plan_matches_baseline(tiny, arch):
    """W = 4, the reference's plan p0 = 2, p1 = 4 over a batch of 8 (and
    of 7, an uneven shard): every rank's logits equal JAX's
    unconstrained forward within 1e-4 and each other bit for bit; the
    hooks make the gathers their design predicts: one at the change of
    degree and one after the last layer, or, in the MoE model, one
    before each MoE sublayer (its dispatch sees every row), whose aux
    loss is the reference's within 1e-5."""
    jcfg, jp, tcfg, tp = tiny if arch == ARCH else _pair(2, arch)
    plan = PlacementPlan.initial(tcfg.num_layers)
    plan.add_replica(0, 1)
    for d in (1, 2, 3):
        plan.add_replica(1, d)
    assert plan.p == [2, 4]
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (8, 16))
    for B in (8, 7):
        want, _, want_aux = jit(JT.forward, jp, jcfg, toks[:B], mode="train")

        def rank(group):
            hook = R.layer_hook_from_plan(plan, group)
            with R.count_collectives(group) as n:
                got, _, aux = T.forward(tp, tcfg, torch.from_numpy(toks[:B]),
                                        mode="train", layer_hook=hook)
            return got.numpy(), float(aux), n

        outs = run_ranks(4, rank)
        for got, aux, n in outs:
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_array_equal(got, outs[0][0])
            assert abs(aux - float(want_aux)) <= 1e-5
            assert n == {"all-gather": 2}


def test_continuity_reduces_collectives():
    """For the same replica count, a contiguous plan (layers 0-3 at
    degree 2 of 8) makes fewer collectives than a fragmented one
    (layers 0, 2, 4, 6): in the forward 1 gather against 4, and in the
    paged decode step 1 + 4 against 4 + 4 (each replicated layer also
    gathers its K/V rows)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_layers=8)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "float32")
    toks = torch.randint(0, cfg.vocab_size, (4, 8),
                         generator=torch.Generator().manual_seed(1))
    contiguous, fragmented = PlacementPlan.initial(8), PlacementPlan.initial(8)
    for i in range(4):
        contiguous.add_replica(i, 1)
        fragmented.add_replica(2 * i, 1)
    bs, width = 4, 4
    tables = torch.arange(4 * width, dtype=torch.int32).view(4, width)

    def rank(group):
        counts = []
        for plan in (contiguous, fragmented):
            hook = R.layer_hook_from_plan(plan, group)
            with R.count_collectives(group) as n:
                T.forward(params, cfg, toks, mode="train", layer_hook=hook)
            counts.append(sum(n.values()))
            pools = {kv: torch.zeros(cfg.num_layers, 4 * width + 1,
                                     cfg.num_kv_heads, bs,
                                     cfg.resolved_head_dim) for kv in "kv"}
            handle = dict(pools, block_tables=tables,
                          lengths=torch.tensor([3, 5, 0, 9]),
                          active=torch.tensor([True, True, False, True]))
            with R.count_collectives(group) as n:
                T.forward_paged(params, cfg, toks[:, :1], handle,
                                layer_hook=hook)
            counts.append(n["all-gather"])
        return counts

    for counts in run_ranks(2, rank):
        assert counts == [1, 5, 4, 8]


def test_migration_moves_bytes_and_preserves_values(tiny):
    """Rank 0 owns the weights, rank 1 holds zeros: re-placing the
    attention weights replicated moves the reference's ``tree_bytes``
    and every rank ends with the owner's values; a split placement keeps
    each rank's shard; a dense cache and a paged pool move alike."""
    jcfg, jp, tcfg, tp = tiny
    expect = JM.tree_bytes(jp, r"layers/attn")
    assert MIG.tree_bytes(tp, r"layers/attn") == expect
    wq = tp["layers"]["attn"]["wq"]

    def rank(group):
        mine = T._tree_map(lambda t: t.clone() if group.rank == 0
                           else torch.zeros_like(t), tp)
        new, cost = MIG.migrate_by_path(mine, r"layers/attn", (), group,
                                        measure=True)
        assert cost.bytes_moved == expect and cost.est_seconds > 0.2
        for name, t in new["layers"]["mlp"].items():   # not matched: kept
            assert t is mine["layers"]["mlp"][name]
        torch.testing.assert_close(new["layers"]["attn"]["wq"], wq,
                                   rtol=0, atol=0)
        if group.rank:
            assert not any(t.any() for t in mine["layers"]["mlp"].values())
        # the heads split over r0: each rank keeps its half
        other = T._tree_map(lambda t: t.clone() if group.rank == 0
                            else torch.zeros_like(t), tp)
        split, _ = MIG.migrate_by_path(other, r"layers/attn/wq$",
                                       (None, None, "r0"), group)
        h = wq.shape[2] // 2
        mine_wq = split["layers"]["attn"]["wq"]
        torch.testing.assert_close(mine_wq,
                                   wq[:, :, group.rank * h:(group.rank + 1) * h],
                                   rtol=0, atol=0)
        # the shard has storage of its own: the full tensor is not kept
        assert (mine_wq.untyped_storage().nbytes()
                == mine_wq.numel() * mine_wq.element_size()
                == wq.numel() * wq.element_size() // 2)
        cache = T.init_cache(tcfg, 2, 16, torch.float32, "cpu")
        if group.rank == 0:
            cache["layers"]["k"].fill_(1.5)
        _, ccost = MIG.migrate_kv_cache(cache, (), group)
        assert ccost.bytes_moved == MIG.tree_bytes(cache, r"layers/")
        assert bool((cache["layers"]["k"] == 1.5).all())
        return True

    assert run_ranks(2, rank) == [True, True]


ROWS = [(0, np.arange(2, 10, dtype=np.int32), 10, 0.0, 0, 0),
        (1, np.arange(5, 18, dtype=np.int32), 12, 0.8, 16, 3),
        (2, np.arange(30, 35, dtype=np.int32), 9, 0.0, 0, 0)]


@pytest.fixture(scope="module")
def reference(tiny4):
    """The unmigrated reference streams of ROWS at 4 layers, one JAX run
    shared by every case."""
    return jax_solo_streams(tiny4[0], tiny4[1], ROWS)


def _serve(tcfg, tp, group, max_batch, plans, migrate_at=None):
    """ROWS through a paged engine of ``group``, ``plans[i]`` applied
    before step i, the pool zeroed on ranks above 0 and re-placed from
    rank 0 before step ``migrate_at``. Returns (streams, tokens of every
    step, the pool's blocks, eager steps, collectives per step, the
    pool's checksum after every step)."""
    e = Engine(tcfg, tp, device="cpu", max_batch=max_batch, max_len=64,
               block_size=8, group=group)
    for spec in specs(ROWS, jax_side=False):
        e.submit(spec)
    out, steps, per_step, sums = [], [], [], []
    for i in range(200):
        if i in plans:
            e.apply_plan(plans[i])
        if i == migrate_at:
            k0 = e.pstate.k
            if group.rank:
                e.pstate.k.zero_()
                e.pstate.v.zero_()
            _, cost = MIG.migrate_paged_pool(e.pstate, (), group)
            assert e.pstate.k is k0
            assert cost.bytes_moved == 2 * k0.numel() * k0.element_size()
        with R.count_collectives(group) as n:
            out += e.step() or []
        per_step.append(sum(n.values()))
        steps.append({r.rid: list(r.generated) for r in e.active.values()})
        sums.append(PK.pool_checksum(e.pstate))
        if not (e.queue or e.active or e.prefilling):
            break
    nb = e.pstate.k.shape[1] - 1
    pool = (e.pstate.k[:, :nb].clone(), e.pstate.v[:, :nb].clone())
    return ({r.rid: r.generated for r in out}, steps, pool,
            e.graphs.counts.eager["decode"], per_step, sums)


def pools_parted(k, pool, pool0, sums, sums0, plans) -> str:
    """Where rank ``k``'s pool (K, V) left rank 0's: the (layer, block)
    pairs that differ, and the first step after which the pools'
    checksums differed, with the plan then in force."""
    where = {}
    for name, a, b in zip("KV", pool, pool0):
        d = (a != b).reshape(a.shape[0], a.shape[1], -1).any(-1)
        where[name] = d.nonzero().tolist()
    first = next((i for i, (x, y) in enumerate(zip(sums, sums0)) if x != y),
                 None)
    plan = (None if first is None else
            max((i for i in plans if i <= first), default=None))
    return (f"rank {k}'s pool differs from rank 0's at (layer, block) "
            f"{where}; the checksums first parted after step {first}, "
            f"under the plan applied before step {plan}: "
            f"{plans.get(plan, 'none')}")


@pytest.mark.parametrize("W,max_batch", [(2, 1), (2, 3), (4, 3)])
def test_apply_plan_mid_decode_matches_reference(tiny4, reference, W,
                                                 max_batch):
    """Mixed degrees, the all-ones plan, degree W everywhere, then a
    contiguous plan, each applied mid-decode: every rank streams what the
    reference engine gives, the ranks' tokens agree at every step, their
    pools end bit-equal, and the replicated steps ran eagerly."""
    _, _, tcfg, tp = tiny4
    L = tcfg.num_layers
    plans = {2: [1, 2, W, 1], 4: [1] * L, 5: [W] * L, 8: [W, W, 1, 1]}

    def rank(group):
        return _serve(tcfg, tp, group, max_batch, plans)

    res = run_ranks(W, rank)
    for k, (streams, steps, pool, eager, per_step, sums) in enumerate(res):
        assert streams == reference
        assert steps == res[0][1]
        for a, b in zip(pool, res[0][2]):
            assert torch.equal(a, b), pools_parted(k, pool, res[0][2], sums,
                                                   res[0][5], plans)
        assert eager > 0
        # no plan, then the all-ones plan: no collective
        assert max(per_step) > 0 and per_step[0] == per_step[4] == 0


def test_migrated_pool_keeps_serving(tiny4, reference):
    """A group of 2 under degree 2: rank 1's pool is lost (zeroed) mid-
    decode and re-placed from rank 0 (``migrate_paged_pool``, in place);
    both ranks then serve on, token-identical to the reference."""
    _, _, tcfg, tp = tiny4

    def rank(group):
        return _serve(tcfg, tp, group, 3, {0: [2] * tcfg.num_layers},
                      migrate_at=4)

    res = run_ranks(2, rank)
    for streams, _, pool, _, _, _ in res:
        assert streams == reference
        for a, b in zip(pool, res[0][2]):
            assert torch.equal(a, b)
