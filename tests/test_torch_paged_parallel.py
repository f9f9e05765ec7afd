"""Port parity, the paged decode step under sharding rules: the port's
``forward_paged`` run by every rank of a thread mesh (``_torch_mesh``)
with its shard of the weights (the reference's ``init_params`` draw,
``_torch_sharded.pair``), its rows of the tokens, block tables, lengths
and ``active``, and its own pool (``paged_kv.init_paged_shard``: its
rows' blocks, allocated by its own allocator, at its KV heads where
``kv_heads`` splits them), against the reference's UNSHARDED
``forward_paged`` on the whole pool: 3 steps, the active rows' logits
within 1e-4 (fp32), every rank's pool blocks after the steps equal to
the reference's blocks of its rows at its KV heads, and the collectives
of each step the design's count.

Cases: reduced tinyllama on (1, 2), (2, 1) and (2, 2) with the
``"gather"`` and ``"kernel"`` routes (the kernel's plain version on the
CPU), one KV head kept whole under split query heads, a window on the
gather route, and reduced qwen2-moe with 12 experts (padded to 16) under
``moe_a2a`` (the expert-parallel dispatch) and under the scatter
dispatch. A pool holds an inactive row (no blocks) and a row whose new
token opens a block."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.bridge import shard_from_numpy
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.serving import paged_kv as PK
from _torch_mesh import rows, run_mesh
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_sharded import pair

TOL = 1e-4
STEPS, BS, N_BLOCKS, MAX_LEN = 3, 4, 24, 32
#: tokens in the pool per row before the steps: row 1 inactive, row 3's
#: first step writes at the start of a new block
LENS = (9, 0, 14, 8)
B = len(LENS)
MOE = ("qwen2-moe-a2.7b", (("num_experts", 12),))


def _tp(L):
    """rules_for with a model axis of 2: the embedding's psum, ``wo``
    and ``w_down`` a layer, the logits' all-gather."""
    return {"all-reduce": 1 + 2 * L, "all-gather": 1}


# name -> (arch, changes, mesh, impl, extra rules, window, collectives of
#          one step from the layer count)
CASES = {
    "tinyllama-1x2-kernel": ("tinyllama-1.1b", (), (1, 2), "kernel", {}, None,
                             _tp),
    "tinyllama-1x2-gather": ("tinyllama-1.1b", (), (1, 2), "gather", {}, None,
                             _tp),
    "tinyllama-2x1-kernel": ("tinyllama-1.1b", (), (2, 1), "kernel", {}, None,
                             lambda L: {}),
    "tinyllama-2x2-kernel": ("tinyllama-1.1b", (), (2, 2), "kernel", {}, None,
                             _tp),
    "tinyllama-2x2-gather": ("tinyllama-1.1b", (), (2, 2), "gather", {}, None,
                             _tp),
    # one KV head, whole on both ranks of model: the pool holds it, each
    # rank's query heads read it on the gather route
    "kv-whole-1x2-kernel": ("tinyllama-1.1b", (("num_kv_heads", 1),), (1, 2),
                            "kernel", {}, None, _tp),
    "window-2x2-gather": ("tinyllama-1.1b", (), (2, 2), "gather", {}, 6, _tp),
    # two all-to-alls a layer
    "moe-a2a-2x1-kernel": (*MOE, (2, 1), "kernel", {"moe_a2a": True}, None,
                           lambda L: {"all-to-all": 2 * L}),
    # the scatter dispatch: the rows gathered over data, the experts and
    # the shared experts' d_ff summed; wo, the embedding, the logits
    "moe-scatter-2x2-gather": (*MOE, (2, 2), "gather", {}, None,
                               lambda L: {"all-reduce": 1 + 4 * L,
                                          "all-gather": 1 + L}),
}


def _pool(tcfg):
    """The whole pool before the steps (random K/V in every block, so the
    masks matter), the block tables of every row (distinct blocks,
    room for the steps; the inactive row has none), the tokens fed."""
    rng = np.random.default_rng(7)
    L, KV, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    k, v = (rng.standard_normal((L, N_BLOCKS, KV, BS, hd)).astype(np.float32)
            for _ in range(2))
    tables = np.full((B, MAX_LEN // BS), -1, np.int32)
    free = list(rng.permutation(N_BLOCKS))
    for b, n in enumerate(LENS):
        if n:
            for j in range(-(-(n + STEPS) // BS)):
                tables[b, j] = free.pop()
    toks = rng.integers(2, tcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return k, v, tables, toks


_REF = {}


def _reference(arch, changes, window):
    """The reference's STEPS paged steps on the whole pool under one jit:
    (logits [STEPS, B, V], the pools after them)."""
    key = (arch, changes, window)
    if key not in _REF:
        jcfg, np_params, tcfg = pair(arch, changes)
        k, v, tables, toks = _pool(tcfg)
        active = np.array([n > 0 for n in LENS])

        def run(p, k, v):
            h = {"k": k, "v": v, "block_tables": jnp.asarray(tables),
                 "lengths": jnp.asarray(LENS, jnp.int32),
                 "active": jnp.asarray(active)}
            out = []
            for t in range(STEPS):
                lg, h, _ = JT.forward_paged(p, jcfg, jnp.asarray(toks[t]), h,
                                            window=window)
                out.append(lg)
            return jnp.stack(out), h["k"], h["v"]

        jp = jax.tree_util.tree_map(jnp.asarray, np_params)
        _REF[key] = jax.tree_util.tree_map(np.asarray,
                                           jax.jit(run)(jp, k, v))
    return _REF[key]


def _rank_pool(tcfg, rules, mesh, k, v, tables):
    """This rank's pool (``init_paged_shard``) holding its rows' blocks
    of the whole pool at its KV heads, each row's blocks allocated anew
    by its own allocator; (state, its rows, the global block of each of
    its blocks, its KV-head slice)."""
    sl = rows(mesh, rules, B)
    st = PK.init_paged_shard(tcfg, B, N_BLOCKS // 2, rules, mesh,
                             block_size=BS, dtype="float32",
                             max_len=MAX_LEN, device="cpu")
    n_kv = st.k.shape[2]
    kv = slice(mesh.axes_index(rules["kv_heads"]) * n_kv,
               (mesh.axes_index(rules["kv_heads"]) + 1) * n_kv)
    where = {}
    for i, b in enumerate(range(B)[sl]):
        if LENS[b]:
            PK.allocate(st, i, LENS[b] + STEPS)
            for j, g in enumerate(tables[b][tables[b] >= 0]):
                blk = int(st.block_tables[i, j])
                st.k[:, blk] = torch.from_numpy(k[:, g, kv])
                st.v[:, blk] = torch.from_numpy(v[:, g, kv])
                where[blk] = int(g)
    return st, sl, where, kv


@pytest.mark.parametrize("case", CASES)
def test_paged_step_matches_reference(case):
    arch, changes, shape, impl, extra, window, per_step = CASES[case]
    _, np_params, tcfg = pair(arch, changes)
    k, v, tables, toks = _pool(tcfg)
    want, want_k, want_v = _reference(arch, changes, window)

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh, **extra)
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
                tok = torch.from_numpy(toks[t, sl])
                if t == 1:      # forward's paged handle reaches the step too
                    lg, h, _ = T.forward(p, tcfg, tok, cache=h, mode="decode",
                                         window=window, attn_impl=impl)
                else:
                    lg, h, _ = T.forward_paged(p, tcfg, tok, h, window=window,
                                               attn_impl=impl)
                colls.append({n: c - before.get(n, 0)
                              for n, c in mesh.collectives.items()
                              if c - before.get(n, 0)})
                out.append(lg)
        return (sl, torch.stack(out).numpy(), colls, where, kv,
                h["k"].numpy(), h["v"].numpy(), h["lengths"].numpy(),
                st.k.shape[2])

    V = tcfg.vocab_size
    active = np.array([n > 0 for n in LENS])
    for sl, got, colls, where, kv, pk, pv, lens, n_kv in run_mesh(shape,
                                                                  rank):
        act = active[sl]
        np.testing.assert_allclose(got[:, act, :V], want[:, sl][:, act, :V],
                                   rtol=TOL, atol=TOL)
        assert colls == [per_step(tcfg.num_layers)] * STEPS
        np.testing.assert_array_equal(lens,
                                      np.asarray(LENS)[sl] + STEPS * act)
        # the pool's KV heads: split over model where kv_heads splits them
        split = SH.rules_for(tcfg, _Shape(shape))["kv_heads"] is not None
        assert n_kv == tcfg.num_kv_heads // (shape[1] if split else 1)
        assert where                       # every rank holds an active row
        for blk, g in where.items():
            np.testing.assert_allclose(pk[:, blk], want_k[:, g, kv],
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(pv[:, blk], want_v[:, g, kv],
                                       rtol=TOL, atol=TOL)


class _Shape:
    """A stand-in mesh of a shape (``rules_for`` reads names and
    shape)."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape, dtype=object)


def test_rank_pool_is_allocated_at_its_shard():
    """``init_paged_shard`` on (2, 2): each rank's pool holds its rows'
    tables and its KV heads, at that local shape."""
    _, _, tcfg = pair("tinyllama-1.1b")

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        st = PK.init_paged_shard(tcfg, 8, 10, rules, mesh, block_size=BS,
                                 dtype="float32", max_len=MAX_LEN,
                                 device="cpu")
        return tuple(st.k.shape), st.block_tables.shape, st.n_blocks

    L, hd = tcfg.num_layers, tcfg.resolved_head_dim
    assert run_mesh((2, 2), rank) == [
        ((L, 11, tcfg.num_kv_heads // 2, BS, hd), (4, MAX_LEN // BS), 10)] * 4


def test_layer_hook_under_rules_raises():
    """A replication ``layer_hook`` and sharding rules each split the
    batch; the paged step refuses the pair."""
    _, np_params, tcfg = pair("tinyllama-1.1b")

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        p = shard_from_numpy(np_params, SH.param_specs(tcfg, np_params, rules,
                                                       mesh), mesh, "cpu")
        st = PK.init_paged_shard(tcfg, 2, 4, rules, mesh, block_size=BS,
                                 dtype="float32", max_len=MAX_LEN,
                                 device="cpu")
        h = {"k": st.k, "v": st.v,
             "block_tables": torch.from_numpy(st.block_tables),
             "lengths": torch.zeros(2, dtype=torch.int32),
             "active": torch.zeros(2, dtype=torch.bool)}
        with SH.use_rules(rules), pytest.raises(NotImplementedError,
                                                match="layer_hook"):
            T.forward_paged(p, tcfg, torch.zeros((2, 1), dtype=torch.long),
                            h, layer_hook=lambda i, x: x)
        return True

    assert run_mesh((1, 2), rank) == [True, True]
