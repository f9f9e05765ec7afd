"""Port parity, the engine's compiled steps (serving/graphs.py) on the CPU:
the fixed-shape pool writes against the reference's drop-mode writes,
rope's per-step tables against the per-layer computation, the static
keys of the decode, chunk and sample graphs, the packed staging buffer,
and the launch accounting. On the CPU the steps run eagerly: the code a
CUDA graph holds on the card (chip_smoke.py holds graphs to the eager
steps there)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.serving import engine as JE
from repro.serving import paged_kv as JPK
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import graphs as GR
from repro_torch.serving import paged_kv as PK
from repro_torch.serving.engine import Engine
from _torch_parity import jit, specs, tiny_pair
from _torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


# ------------------------------------------------------- fixed-shape writes
def _int_params(cfg, rng):
    """GQA weights of small integers: with integer inputs every product
    and sum is exact in fp32, so both frameworks compute the same K/V."""
    hd, H, KV, d = (cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads,
                    cfg.d_model)
    shapes = {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd),
              "wo": (H * hd, d)}
    return {k: rng.integers(-2, 3, size=s).astype(np.float32)
            for k, s in shapes.items()}


def test_decode_write_matches_reference_drop_write():
    """One layer's write-then-attend: an inactive row, an active row whose
    write column is unallocated (-1) and one whose position is past the
    table (clamped to the last column, as in the reference) — the port's
    fixed-shape write (every row written, dropped rows into the scratch
    block) leaves every real block bit-equal in fp32 to the reference's
    ``mode="drop"`` write."""
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               use_rope=False)
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               use_rope=False)
    rng = np.random.default_rng(0)
    n, bs, KV, hd = 10, 4, tcfg.num_kv_heads, tcfg.resolved_head_dim
    pool = rng.standard_normal((2, n + 1, KV, bs, hd)).astype(np.float32)
    tables = np.array([[2, 5, -1], [7, -1, -1], [1, -1, -1], [3, 4, 8],
                       [9, -1, -1]], np.int32)
    lengths = np.array([6, 2, 5, 14, 0], np.int32)
    active = np.array([True, False, True, True, True])
    x = rng.integers(-2, 3, size=(5, 1, tcfg.d_model)).astype(np.float32)
    p = _int_params(tcfg, rng)
    _, wk, wv = jit(JL.apply_gqa_paged, {k: jnp.asarray(a) for k, a in
                                         p.items()}, jnp.asarray(x), jcfg,
                    positions=jnp.asarray(lengths[:, None]),
                    pool_k=jnp.asarray(pool[0, :n]),
                    pool_v=jnp.asarray(pool[1, :n]),
                    block_tables=jnp.asarray(tables),
                    active=jnp.asarray(active), impl="gather")
    tk, tv = torch.from_numpy(pool[0].copy()), torch.from_numpy(pool[1].copy())
    pos, tbl, act = (torch.from_numpy(lengths[:, None]),
                     torch.from_numpy(tables), torch.from_numpy(active))
    meta = TL.paged_step_meta(pos, tbl, act, n, bs)
    blk, off = meta["write"]
    assert blk.tolist() == [5, n, n, 8, 9]          # fixed shape [B]
    assert off.tolist() == [2, 2, 1, 2, 0]
    TL.apply_gqa_paged({k: torch.from_numpy(a) for k, a in p.items()},
                       torch.from_numpy(x), tcfg, positions=pos, pool_k=tk,
                       pool_v=tv, block_tables=tbl, active=act,
                       impl="gather")
    np.testing.assert_array_equal(tk[:n].numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv[:n].numpy(), np.asarray(wv))
    assert not torch.equal(tk[n], torch.from_numpy(pool[0, n]))  # took drops


def _twin_pools(tiny, lens, n=12, bs=4):
    jcfg, _, tcfg, _ = tiny
    js = JPK.init_paged(jcfg, 3, n, block_size=bs, dtype="float32",
                        max_len=32)
    ts = PK.init_paged(tcfg, 3, n, block_size=bs, dtype="float32",
                       max_len=32, device="cpu")
    rng = np.random.default_rng(1)
    L, KV, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    for slot, m in enumerate(lens):
        kv = rng.standard_normal((2, L, m, KV, hd)).astype(np.float32)
        JPK.allocate(js, slot, m)
        js = JPK.write_tokens(js, slot, jnp.asarray(kv[0]), jnp.asarray(kv[1]))
        PK.allocate(ts, slot, m)
        PK.write_tokens(ts, slot, torch.from_numpy(kv[0]),
                        torch.from_numpy(kv[1]))
    return js, ts


def test_suffix_scatter_with_pad_rows_matches_reference(tiny):
    """The chunk path's suffix write (``paged_kv.scatter_rows`` over a
    ``scatter_plan`` of fixed shape [G*Sb]) with a pad row, pad positions
    and a hole: every real block bit-equal to the reference's drop
    write (its ``write_tokens_batch``) of the same K/V."""
    js, ts = _twin_pools(tiny, [5, 3, 0])
    for st, P in ((js, JPK), (ts, PK)):
        P.allocate(st, 0, 3)
        P.allocate(st, 1, 2)
        st.block_tables[1, 1] = -1          # a hole under a live position
    L, KV, hd = ts.k.shape[0], ts.k.shape[2], ts.k.shape[4]
    G, Sb = 3, 4
    k = np.random.default_rng(2).standard_normal(
        (2, L, G, Sb, KV, hd)).astype(np.float32)
    lens = [3, 2, 0]                        # the last row is a pad row
    js = JPK.write_tokens_batch(js, [0, 1, 1], jnp.asarray(k[0]),
                                jnp.asarray(k[1]), lengths=lens)
    bidx, oidx = PK.scatter_plan(ts, [0, 1, 1], Sb, lengths=lens)
    assert bidx.shape == (G * Sb,) and (bidx == ts.n_blocks).sum() > 0
    PK.scatter_rows(ts.k, ts.v, torch.from_numpy(bidx.astype(np.int64)),
                    torch.from_numpy(oidx.astype(np.int64)),
                    torch.from_numpy(k[0]).reshape(L, G * Sb, KV, hd),
                    torch.from_numpy(k[1]).reshape(L, G * Sb, KV, hd))
    np.testing.assert_array_equal(ts.k[:, :-1].numpy(), np.asarray(js.k))
    np.testing.assert_array_equal(ts.v[:, :-1].numpy(), np.asarray(js.v))
    np.testing.assert_array_equal(ts.lengths, js.lengths)


def test_chunk_step_matches_reference_chunk_prefill(tiny):
    """The chunk graph's function (packed operands, fixed-shape suffix
    write) against the reference's ``_chunk_prefill_fn`` on the same pool,
    with a pad row: the real row's logits and the written blocks agree
    (fp32, 1e-4), every other real block is bit-equal."""
    jcfg, jp, tcfg, tp = tiny
    js, ts = _twin_pools(tiny, [5, 0, 0])
    bs, ctx, n_new, G, Sb = 4, 5, 3, 2, 4
    cb, cache_len = 8, 12
    n_blk = cb // bs
    for st, P in ((js, JPK), (ts, PK)):
        P.allocate(st, 0, n_new)
    tbl = ts.block_tables[[0, 0], :n_blk]
    tbl = np.where(tbl >= 0, tbl, 0).astype(np.int64)
    pos = np.full((G, cache_len), TT.BIG_POS, np.int32)
    pos[:, :ctx] = np.arange(ctx)
    suffix = np.zeros((G, Sb), np.int32)
    suffix[0, :n_new] = [7, 11, 13]
    spos = np.tile(np.arange(ctx, ctx + Sb, dtype=np.int32), (G, 1))
    last = np.asarray([n_new, 0]) - 1
    jb, jo = JPK.scatter_plan(js, [0, 0], Sb, lengths=[n_new, 0])
    tb, to = PK.scatter_plan(ts, [0, 0], Sb, lengths=[n_new, 0])
    np.testing.assert_array_equal(tb, jb)
    want, wk, wv = JE._chunk_prefill_fn(
        jp, js.k, js.v, jnp.asarray(tbl), jnp.asarray(suffix),
        jnp.asarray(spos), jnp.asarray(pos), jnp.asarray(last),
        jnp.asarray(jb), jnp.asarray(jo), cfg=jcfg, window=None,
        cache_len=cache_len, dtype="float32")
    buf = torch.from_numpy(GR.pack(tbl, suffix, spos, pos, last, tb, to))
    k0 = ts.k.clone()
    got = TE._chunk_step(tp, ts.k, ts.v, buf, cfg=tcfg, window=None, G=G,
                         n_blk=n_blk, Sb=Sb, cache_len=cache_len,
                         dtype=torch.float32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0],
                               rtol=1e-4, atol=1e-4)
    written = sorted({int(b) for b in tb if b < ts.n_blocks})
    np.testing.assert_allclose(ts.k[:, :-1].numpy(), np.asarray(wk),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.v[:, :-1].numpy(), np.asarray(wv),
                               rtol=1e-4, atol=1e-4)
    rest = [b for b in range(ts.n_blocks) if b not in written]
    np.testing.assert_array_equal(ts.k[:, rest].numpy(),
                                  np.asarray(wk)[:, rest])
    np.testing.assert_array_equal(ts.k[:, rest].numpy(), k0[:, rest].numpy())


# ---------------------------------------------------------------- rope
def test_rope_tables_bit_identical_to_per_layer_rope():
    """Rope's cos / sin computed once per step give bit-identical q and k
    to computing them in every layer (the same ops on the same inputs)."""
    cfg = get_config("tinyllama-1.1b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = TL.init_gqa(cfg, gen, torch.float32)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 5, cfg.d_model))
                         .astype(np.float32))
    positions = torch.from_numpy(rng.integers(0, 900, (3, 5)).astype(np.int32))
    per_layer = TL._qkv(p, x, cfg, positions)
    tables = TL.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    hoisted = TL._qkv(p, x, cfg, positions, tables)
    for a, b in zip(per_layer, hoisted):
        assert torch.equal(a, b)
    for dtype in (torch.float32, torch.bfloat16):
        q = x[..., :cfg.resolved_head_dim * 2].reshape(3, 5, 2, -1).to(dtype)
        assert torch.equal(TL.apply_rope(q, positions, cfg.rope_theta),
                           TL.apply_rope(q, None, None, tables))


# ------------------------------------------------------------ graph keys
def _serve(tcfg, tp, rows, **kw):
    eng = Engine(tcfg, tp, device="cpu", max_batch=2, max_len=64,
                 block_size=4, **kw)
    for s in specs(rows, jax_side=False):
        eng.submit(s)
    out = {r.rid: r.generated for r in eng.run_until_done()}
    return eng, out


def _rows(seed, temp, top_k):
    rng = np.random.default_rng(seed)
    return [(0, rng.integers(2, 200, 5).astype(np.int32), 8, temp, top_k,
             seed), (1, rng.integers(2, 200, 30).astype(np.int32), 8, 0.0, 0,
                     seed + 1)]


def test_graph_keys_follow_the_reference_static_arguments(tiny):
    """The decode key changes with the table width ``nb``, ``stochastic``
    and ``max_top_k`` — the reference jit's static arguments — and not
    with lengths' values within a width, tokens, temperatures or seeds;
    chunk and sample keys likewise."""
    _, _, tcfg, tp = tiny
    a, _ = _serve(tcfg, tp, _rows(1, 0.7, 5))
    b, _ = _serve(tcfg, tp, _rows(2, 1.3, 5))
    c, _ = _serve(tcfg, tp, _rows(1, 0.7, 3))
    d, _ = _serve(tcfg, tp, _rows(1, 0.0, 0))
    assert set(a.graphs.keys) == set(b.graphs.keys)

    def decode(e):
        return {k for k in e.graphs.keys if k[0] == "decode"}
    # lengths 30 .. 37 in blocks of 4: table widths 8, then 16
    assert {k[1] for k in decode(a)} == {8, 16}
    assert {(k[2], k[3]) for k in decode(a)} == {(True, 5)}
    assert {(k[2], k[3]) for k in decode(c)} == {(True, 3)}
    assert {(k[2], k[3]) for k in decode(d)} == {(False, 0)}
    assert {k[1] for k in decode(c)} == {k[1] for k in decode(d)} == {8, 16}
    # every step of a run maps to one of its few keys
    steps = sum(n for k, n in a.graphs.keys.items() if k[0] == "decode")
    assert steps == a._step_count and len(decode(a)) == 2
    assert a.graphs.counts.captures == {} and not a.graphs.enabled


def test_cuda_graphs_off_runs_the_same_steps(tiny):
    """``cuda_graphs=False`` (the eager comparison on the card) serves
    the same streams; on the CPU both run the graph functions eagerly."""
    _, _, tcfg, tp = tiny
    rows = _rows(4, 0.9, 7)
    _, on = _serve(tcfg, tp, rows)
    _, off = _serve(tcfg, tp, rows, cuda_graphs=False)
    assert on == off


# ----------------------------------------------------- staging buffer
def test_pack_round_trips_every_operand():
    """The decode step's one upload: tokens, lengths, active mask,
    temperatures, top-ks, seeds and counters (full uint32 range) and the
    table slice come back exactly from the packed int32 buffer, as
    ``_decode_step`` unpacks them; the chunk step's int64 operands too."""
    B, nb = 3, 4
    tokens = np.array([5, 0, 31999], np.int32)
    lengths = np.array([0, 17, 1023], np.int32)
    active = np.array([True, False, True])
    temps = np.array([0.0, 0.8, 1e-30], np.float32)
    topks = np.array([0, 8, 31999], np.int32)
    seeds = np.array([0, 2 ** 31, 2 ** 32 - 1], np.uint32)
    ctrs = np.array([1, 2 ** 31 - 1, 2 ** 32 - 2], np.uint32)
    tables = np.array([[3, -1, 7, 8], [0, 1, 2, -1], [-1] * 4], np.int32)
    buf = torch.from_numpy(GR.pack(tokens, lengths, active, temps, topks,
                                   seeds, ctrs, tables[:, :nb]))
    assert buf.dtype == torch.int32 and buf.numel() == B * (7 + nb)
    t, ln, ac, te, tk, se, ct, tb = GR.unpack(buf, *[(B,)] * 7, (B, nb))
    np.testing.assert_array_equal(t.numpy(), tokens)
    np.testing.assert_array_equal(ln.numpy(), lengths)
    np.testing.assert_array_equal((ac != 0).numpy(), active)
    np.testing.assert_array_equal(te.view(torch.float32).numpy(), temps)
    np.testing.assert_array_equal(tk.numpy(), topks)
    np.testing.assert_array_equal(GR.as_uint32(se).numpy(),
                                  seeds.astype(np.int64))
    np.testing.assert_array_equal(GR.as_uint32(ct).numpy(),
                                  ctrs.astype(np.int64))
    np.testing.assert_array_equal(tb.numpy(), tables)
    idx = np.array([[0, 11], [12, 2 ** 30]], np.int64)
    last = np.array([4, -1], np.int64)
    i2, l2 = GR.unpack(torch.from_numpy(GR.pack(idx, last)), (2, 2), (2,))
    np.testing.assert_array_equal(i2.long().numpy(), idx)
    np.testing.assert_array_equal(l2.long().numpy(), last)
    with pytest.raises(ValueError, match="words"):
        GR.unpack(buf, (B,))


def test_step_graphs_on_the_cpu_and_launch_accounting():
    """On the CPU ``run`` calls the step function eagerly on the inputs
    (host arrays as tensors), counts the key, captures nothing; and
    ``launches_run`` counts eager calls, minus calls made while recording,
    plus each replay's recorded launches."""
    g = GR.StepGraphs("cpu")
    out = g.run(("decode", 4), lambda a, b: a + b.long(),
                np.array([1, 2], np.int32), torch.tensor([10, 20]))
    assert out.tolist() == [11, 22] and g.keys[("decode", 4)] == 1
    assert not g.enabled and g.pool_bytes() == 0

    def kernel():
        pass
    kernel.launches = 22 * 3 + 22           # warm-ups and eager, capture
    g.recorded_calls["kernel"] = 22         # one capture recorded 22
    g.replayed["kernel"] = 22 * 5           # five replays
    assert GR.launches_run(kernel, [g]) == 22 * 8


def test_forward_paged_takes_operands_on_the_pool_device(tiny):
    """The step takes no host array: an operand off the pool's device
    raises instead of being uploaded inside the step."""
    _, _, tcfg, tp = tiny
    st = PK.init_paged(tcfg, 2, 8, block_size=4, dtype="float32",
                       max_len=16, device="cpu")
    handle = {"k": st.k, "v": st.v,
              "block_tables": torch.zeros((2, 4), dtype=torch.int32,
                                          device="meta"),
              "lengths": torch.zeros(2, dtype=torch.int32),
              "active": torch.ones(2, dtype=torch.bool)}
    with pytest.raises(ValueError, match="pool's device"):
        TT.forward_paged(tp, tcfg, torch.zeros((2, 1), dtype=torch.int32),
                         handle)
