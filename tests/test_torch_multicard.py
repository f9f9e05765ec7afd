"""Ranks one per card over NCCL, on the CPU: the backend each mesh and
replication group takes (``parallel.mesh.backend_for``), the groups
``RankMesh.build``, ``make_host_mesh`` and ``ReplicationGroup.build``
make through a stand-in ``ProcessGroupNCCL`` (the CPU build has none),
the engine's route for a replicated decode step (a graph where the group
is ``capturable``, eager where it stages through the host) against the
reference engine's tokens, llama2-70b's rank shape under rules on (1, 4)
against the reference's unsharded paged step, and the sharded draw
(``transformer.init_params_shard``) against ``shard_params`` of the
whole draw. Ranks are threads of this process (no process is spawned);
``chip_multicard.py`` runs the same on four cards."""
import dataclasses
import datetime
import itertools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.bridge import shard_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import replication as R
from repro_torch.launch import mesh as LM
from repro_torch.launch.dryrun import MemoryTally, tree_bytes
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.parallel import mesh as M
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import RankMesh
from repro_torch.serving.engine import Engine
from _torch_mesh import run_mesh, run_threads
from _torch_parity import jax_solo_streams, specs, tiny_pair
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import partitionable_threefry  # noqa: F401
from test_torch_paged_parallel import (BS, LENS, MAX_LEN, STEPS, _pool,
                                       _rank_pool, _reference)

TIMEOUT = datetime.timedelta(seconds=60)
_PREFIX = itertools.count()
#: llama2-70b at its reduced widths with 8 query and 4 KV heads, so both
#: split four ways on (1, 4), as 64 and 8 do at published width
LLAMA70 = ("llama2-70b", (("num_heads", 8), ("num_kv_heads", 4)))


class _FakeNCCL:
    """Stands in for ``dist.ProcessGroupNCCL``: records its rank and size
    and leaves a key in its store, so a test reads the prefix it got."""

    class Options:
        def __init__(self):
            self._timeout = None

    def __init__(self, store, rank, size, opts):
        store.set("made", f"{rank}/{size}")
        self._rank, self._size, self.timeout = rank, size, opts._timeout

    def name(self):
        return "nccl"

    def rank(self):
        return self._rank

    def size(self):
        return self._size


@pytest.fixture
def fake_nccl(monkeypatch):
    monkeypatch.setattr(dist, "ProcessGroupNCCL", _FakeNCCL, raising=False)
    return _FakeNCCL


@pytest.mark.parametrize("devices,want", [
    (["cpu"] * 4, "gloo"),
    (["cuda:0"] * 2, "gloo"),                       # two ranks share a card
    ([f"cuda:{r}" for r in range(4)], "nccl"),      # a card each
    (["cuda:1"], "nccl"),
    (["cpu", "cuda:0"], ValueError),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:2"], ValueError),
])
def test_backend_for(devices, want):
    """A card each takes NCCL; one shared card or the CPU takes gloo; any
    other mix raises."""
    if want is ValueError:
        with pytest.raises(ValueError, match="neither"):
            M.backend_for(devices)
    else:
        assert M.backend_for(devices) == want


def test_mesh_builds_nccl_per_axis_line(fake_nccl):
    """(2, 2) with a card per rank: one NCCL group per axis line through
    each rank, under the prefix ``{axis}/{line}``, at the rank's place on
    the line; no gloo group."""
    store = dist.HashStore()

    def rank(r):
        return RankMesh.build(store, ("data", "model"), (2, 2), r,
                              f"cuda:{r}", TIMEOUT)

    meshes = run_threads(4, rank)
    for r, m in enumerate(meshes):
        d, c = m.coords
        assert set(m.groups) == {"data", "model"}
        assert all(isinstance(g, fake_nccl) for g in m.groups.values())
        assert (m.groups["data"].rank(), m.groups["data"].size()) == (d, 2)
        assert (m.groups["model"].rank(), m.groups["model"].size()) == (c, 2)
        assert m.groups["model"].timeout == TIMEOUT
        assert m.device == torch.device("cuda", r)
    # each line's group wrote under its own prefix, each rank at its place
    assert store.get("model/0/made") in (b"0/2", b"1/2")
    assert store.get("model/1/made") in (b"0/2", b"1/2")
    assert store.get("data/0/made") in (b"0/2", b"1/2")
    assert store.get("data/1/made") in (b"0/2", b"1/2")


def test_shared_card_mesh_takes_gloo(fake_nccl):
    """Two ranks on one card (phase 13's layout) keep gloo groups."""
    store = dist.HashStore()
    meshes = run_threads(2, lambda r: RankMesh.build(
        store, ("data", "model"), (1, 2), r, "cuda:0", TIMEOUT))
    assert [m.groups["model"].name() for m in meshes] == ["gloo"] * 2


def test_failing_nccl_raises(monkeypatch):
    """A card per rank whose NCCL group fails raises; no gloo group
    stands in."""
    class Broken(_FakeNCCL):
        def __init__(self, *args):
            raise RuntimeError("NCCL unavailable")

    monkeypatch.setattr(dist, "ProcessGroupNCCL", Broken, raising=False)
    store = dist.HashStore()
    with pytest.raises(RuntimeError, match="NCCL unavailable"):
        run_threads(2, lambda r: RankMesh.build(store, ("data", "model"), (1, 2),
                                             r, f"cuda:{r}", TIMEOUT))


def test_host_mesh_gives_each_rank_its_card(fake_nccl):
    """``make_host_mesh`` on a CUDA device: rank r on ``cuda:r``, NCCL."""
    store = dist.HashStore()
    meshes = run_threads(2, lambda r: LM.make_host_mesh(store, r, "cuda", n=2))
    assert [str(m.device) for m in meshes] == ["cuda:0", "cuda:1"]
    assert all(isinstance(m.groups["data"], fake_nccl) for m in meshes)


def test_replication_group_build(fake_nccl):
    """``ReplicationGroup.build``: a card each gives NCCL, capturable and
    not staged; the CPU gives gloo, neither."""
    store = dist.HashStore()
    groups = run_threads(4, lambda r: R.ReplicationGroup.build(
        dist.PrefixStore("card", store), r, 4, f"cuda:{r}", TIMEOUT))
    assert [g.rank for g in groups] == [0, 1, 2, 3]
    for g in groups:
        assert isinstance(g.pg, fake_nccl) and g.pg.size() == 4
        assert g.capturable and not g.staged
    assert store.get("card/pg/made") in (b"0/4", b"1/4", b"2/4", b"3/4")
    cpu = run_threads(2, lambda r: R.ReplicationGroup.build(
        dist.PrefixStore("cpu", store), r, 2, "cpu", TIMEOUT))
    assert [g.pg.name() for g in cpu] == ["gloo", "gloo"]
    assert not any(g.capturable for g in cpu)
    assert R.default_replication_group().capturable   # runs no collective


class _NcclNamed:
    """A gloo process group that names itself NCCL: on the CPU, what an
    engine sees of a group whose collectives run on the card."""

    def __init__(self, pg):
        self._pg = pg

    def name(self):
        return "nccl"

    def __getattr__(self, attr):
        return getattr(self._pg, attr)


ROWS = [(0, np.arange(2, 10, dtype=np.int32), 8, 0.0, 0, 0),
        (1, np.arange(5, 18, dtype=np.int32), 9, 0.8, 16, 3),
        (2, np.arange(30, 35, dtype=np.int32), 7, 0.0, 0, 0)]


@pytest.fixture(scope="module")
def engine_pair():
    import jax

    jcfg, jp, tcfg, tp = tiny_pair()
    with jax.threefry_partitionable(True):
        ref = jax_solo_streams(jcfg, jp, ROWS)
    return tcfg, tp, ref


@pytest.mark.parametrize("capturable", [True, False])
def test_engine_routes_replicated_step(engine_pair, capturable):
    """Two ranks under degree 2 everywhere, then a mixed plan: over a
    capturable group every replicated decode step goes through
    ``graphs.run`` under a key holding its degrees (no eager step); over
    gloo, through ``graphs.eager``. Both stream the reference engine's
    tokens, and both ranks agree."""
    tcfg, tp, ref = engine_pair
    L = tcfg.num_layers
    prefix = f"route{next(_PREFIX)}"
    store = dist.HashStore()

    def rank(r):
        pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), r, 2,
                                   TIMEOUT)
        group = R.ReplicationGroup.of(_NcclNamed(pg) if capturable else pg,
                                      "cpu")
        assert group.capturable == capturable
        e = Engine(tcfg, tp, device="cpu", max_batch=3, max_len=64,
                   block_size=8, group=group)
        for spec in specs(ROWS, jax_side=False):
            e.submit(spec)
        out, gathers = [], 0
        plans = {0: [2] * L, 4: [2] + [1] * (L - 1)}
        for i in range(100):
            if i in plans:
                e.apply_plan(plans[i])
            with R.count_collectives(group) as n:
                out += e.step() or []
            gathers += n.get("all-gather", 0)
            if not (e.queue or e.active or e.prefilling):
                break
        keys = {k[4] for k in e.graphs.keys if k[0] == "decode"}
        return ({q.rid: q.generated for q in out},
                e.graphs.counts.eager["decode"], keys, gathers)

    res = run_threads(2, rank)
    replicated = {(2,) * L, (2,) + (1,) * (L - 1)}
    for streams, eager, keys, gathers in res:
        assert streams == ref
        assert replicated <= keys <= replicated | {None}
        assert gathers > 0
        assert (eager == 0) == capturable


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_llama70b_rank_step_on_four(impl):
    """llama2-70b's head geometry (8 query, 4 KV heads at reduced width)
    on (data 1, model 4): each rank runs the paged step at 2 query heads
    and 1 KV head of its own pool; 3 steps against the reference's
    unsharded ``forward_paged`` on the whole pool (fp32 1e-4), 1 + 2L
    all-reduces and one all-gather a step, each rank's pool blocks
    against the reference's at its KV head."""
    from _torch_sharded import pair

    arch, changes = LLAMA70
    _, np_params, tcfg = pair(arch, changes)
    k, v, tables, toks = _pool(tcfg)
    want, want_k, want_v = _reference(arch, changes, None)

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        p = shard_from_numpy(np_params, SH.param_specs(tcfg, np_params, rules,
                                                       mesh), mesh, "cpu")
        st, sl, where, kv = _rank_pool(tcfg, rules, mesh, k, v, tables)
        lens = np.asarray(LENS, np.int32)[sl]
        h = {"k": st.k, "v": st.v,
             "block_tables": torch.from_numpy(st.block_tables),
             "lengths": torch.from_numpy(lens),
             "active": torch.from_numpy(lens > 0)}
        out, colls = [], []
        with SH.use_rules(rules):
            for t in range(STEPS):
                before = dict(mesh.collectives)
                lg, h, _ = T.forward_paged(p, tcfg, torch.from_numpy(toks[t, sl]),
                                           h, attn_impl=impl)
                colls.append({n: c - before.get(n, 0)
                              for n, c in mesh.collectives.items()
                              if c - before.get(n, 0)})
                out.append(lg)
        return (torch.stack(out).numpy(), colls, where, kv, h["k"].numpy(),
                p["layers"]["attn"]["wq"].shape, st.k.shape)

    L, V = tcfg.num_layers, tcfg.vocab_size
    active = np.array([n > 0 for n in LENS])
    for got, colls, where, kv, pk, wq, pool in run_mesh((1, 4), rank):
        np.testing.assert_allclose(got[:, active, :V], want[:, active, :V],
                                   rtol=1e-4, atol=1e-4)
        assert colls == [{"all-reduce": 1 + 2 * L, "all-gather": 1}] * STEPS
        assert wq[-2] == 2 and pool[2] == 1 and pool[3] == BS
        for blk, g in where.items():
            np.testing.assert_allclose(pk[:, blk], want_k[:, g, kv],
                                       rtol=1e-4, atol=1e-4)
    assert MAX_LEN // BS == tables.shape[1]


@pytest.mark.parametrize("arch,changes,shape", [
    (*LLAMA70, (1, 4)),
    (*LLAMA70, (2, 2)),
    ("tinyllama-1.1b", (), (4, 1)),
    ("qwen2-moe-a2.7b", (), (1, 4)),
    ("mamba2-780m", (), (1, 4)),
    ("whisper-medium", (), (2, 2)),
])
def test_sharded_draw_is_the_shard_of_the_draw(arch, changes, shape):
    """Every rank of a 4-rank mesh: ``init_params_shard`` equals
    ``shard_params(init_params(...))`` bit for bit, leaf for leaf, from
    the same seed. For a dense decoder the draw's peak
    (``MemoryTally``) is the rank's shards and one fp32 chunk, at most
    one layer's slice of a leaf; an MoE's experts and a Mamba2 stack's
    layers are drawn whole and sliced (equality only)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    full = T.init_params(cfg, torch.Generator().manual_seed(5), "bfloat16")
    for r in range(4):
        mesh = RankMesh.dry(("data", "model"), shape, r, device="cpu")
        rules = SH.rules_for(cfg, mesh)
        want = SH.shard_params(full, SH.param_specs(cfg, full, rules, mesh), mesh)
        with MemoryTally((torch.empty(0),)) as tally:
            got = T.init_params_shard(cfg, torch.Generator().manual_seed(5),
                                      rules, mesh, "bfloat16")
        pairs = []
        SH.tree_map(lambda a, b: pairs.append((a, b)), got, want)
        assert pairs and all(a.shape == b.shape and torch.equal(a, b)
                             for a, b in pairs)
        if cfg.family == "dense" and not cfg.num_experts:
            L = cfg.num_layers
            slices = [x.numel() // L if x.dim() > 2 and x.shape[0] == L
                      else x.numel() for x in _leaves(full)]
            chunk = 4 * min(max(slices), TL.DRAW_ELEMS)
            assert tally.peak - tally.base <= tree_bytes(got) + chunk


def _leaves(tree):
    out = []
    SH.tree_map(out.append, tree)
    return out
