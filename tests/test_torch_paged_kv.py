"""Port parity, paged KV pool: the host bookkeeping (refcounts, prefix
cache, copy-on-write, window release) keeps the reference's invariants;
the content chain keys are byte-identical; the device writes and
gathers match the reference's pool bit for bit in fp32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.serving import paged_kv as JPK
from repro_torch.configs import get_config
from repro_torch.serving import paged_kv as PK
from _torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def cfg():
    return get_config("tinyllama-1.1b").reduced()


def _check_invariants(st: PK.PagedState):
    """The PagedState refcount invariants from the dataclass docstring."""
    held = np.zeros(st.n_blocks, np.int64)
    for row in st.block_tables:
        for b in row:
            if b >= 0:
                held[b] += 1
    np.testing.assert_array_equal(held, st.refcount)
    for b in st.free:
        assert st.refcount[b] == 0 and b not in st.block_key
    for b in st.cached_free:
        assert st.refcount[b] == 0 and b in st.block_key
    for key, b in st.prefix_cache.items():
        assert st.block_key[b] == key
    assert len(st.prefix_cache) == len(st.block_key)


def _pool(cfg, max_batch, n_blocks, **kw):
    return PK.init_paged(cfg, max_batch, n_blocks, dtype="float32",
                         device="cpu", **kw)


def test_refcount_lifecycle(cfg):
    """free -> owned -> shared -> cached-free -> revived -> evicted."""
    st = _pool(cfg, 3, 8, block_size=4, max_len=32, prefix_cache=True)
    toks = np.arange(2, 11, dtype=np.int32)         # 9 tokens: 2 full blocks
    PK.allocate(st, 0, len(toks))
    assert st.blocks_in_use() == 3
    assert PK.register_prefix(st, 0, toks) == 2     # partial col 2 skipped
    _check_invariants(st)
    matched = PK.match_prefix(st, toks)
    assert len(matched) == 2
    PK.adopt_prefix(st, 1, matched, 8)
    assert st.shared_blocks_saved() == 2 and st.blocks_in_use() == 3
    _check_invariants(st)
    PK.free_slot(st, 0)                             # shared blocks survive
    assert st.shared_blocks_saved() == 0 and st.blocks_in_use() == 2
    _check_invariants(st)
    PK.free_slot(st, 1)                             # park on cached_free
    assert st.blocks_in_use() == 0 and len(st.cached_free) == 2
    revived = PK.match_prefix(st, toks)
    assert revived == matched
    PK.adopt_prefix(st, 2, revived, 8)
    assert not st.cached_free
    _check_invariants(st)
    PK.free_slot(st, 2)
    PK.allocate(st, 0, 8 * 4)                       # pressure evicts cache
    assert st.blocks_in_use() == 8
    assert not st.prefix_cache and not st.cached_free
    _check_invariants(st)
    with pytest.raises(PK.OutOfBlocks):
        PK.allocate(st, 1, 4)
    assert PK.prefix_stats(st)["hits"] == 4


def test_cow_fork_isolates_writer(cfg):
    """ensure_writable forks a shared block on the device: the writer gets
    a private copy with the same content, the co-holder keeps its block."""
    st = _pool(cfg, 2, 8, block_size=4, max_len=32, prefix_cache=True)
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(0)
    toks = rng.integers(2, 100, size=8).astype(np.int32)
    kv = torch.from_numpy(rng.standard_normal((L, 8, KV, hd)).astype(
        np.float32))
    PK.allocate(st, 0, 8)
    PK.write_tokens(st, 0, kv, kv * 2)
    PK.register_prefix(st, 0, toks)
    PK.adopt_prefix(st, 1, PK.match_prefix(st, toks), 7)
    epoch = st.write_epoch
    assert PK.ensure_writable(st, 1, 7, 1) == 1     # forks shared col 1
    assert st.cow_forks == 1 and st.write_epoch == epoch + 1
    assert st.block_tables[0, 1] != st.block_tables[1, 1]
    assert st.block_tables[0, 0] == st.block_tables[1, 0]
    _check_invariants(st)
    k0, v0 = PK.gather_request(st, 0, 8)
    k1, v1 = PK.gather_request(st, 1, 8)
    assert torch.equal(k0, k1) and torch.equal(v0, v1)
    assert torch.equal(k0, kv)
    assert PK.ensure_writable(st, 1, 7, 1) == 0     # now owned


def test_out_of_window_release_is_decref(cfg):
    st = _pool(cfg, 2, 8, block_size=4, max_len=64, prefix_cache=True)
    toks = np.arange(2, 10, dtype=np.int32)
    PK.allocate(st, 0, 8)
    PK.register_prefix(st, 0, toks)
    PK.adopt_prefix(st, 1, PK.match_prefix(st, toks), 8)
    shared0 = int(st.block_tables[0, 0])
    st.lengths[0] = 9
    assert PK.free_out_of_window(st, 0, window=4) == 1
    assert st.refcount[shared0] == 1 and st.block_tables[1, 0] == shared0
    _check_invariants(st)


@pytest.mark.parametrize("bs", [1, 4, 16])
def test_chain_keys_byte_identical(bs):
    rng = np.random.default_rng(bs)
    for n in (0, bs - 1, bs, 3 * bs + 2, 70):
        toks = rng.integers(0, 32000, size=max(n, 0))
        assert PK._chain_keys(toks, bs) == JPK._chain_keys(toks, bs)
        assert PK._chain_keys(list(toks), bs) == JPK._chain_keys(toks, bs)


def _twin_pools(lens, *, holes=(), n_blocks=12, bs=4, max_len=32):
    """The same allocation in both packages (holes punched at the given
    (slot, column) cells after allocation)."""
    jcfg, tcfg = jax_config("tinyllama-1.1b").reduced(), \
        get_config("tinyllama-1.1b").reduced()
    js = JPK.init_paged(jcfg, len(lens), n_blocks, block_size=bs,
                        dtype="float32", max_len=max_len)
    ts = PK.init_paged(tcfg, len(lens), n_blocks, block_size=bs,
                       dtype="float32", max_len=max_len, device="cpu")
    for st, P in ((js, JPK), (ts, PK)):
        for slot, n in enumerate(lens):
            P.allocate(st, slot, n)
        for slot, col in holes:
            P._decref(st, int(st.block_tables[slot, col]))
            st.block_tables[slot, col] = -1
    return jcfg, js, ts


def test_write_tokens_batch_matches_reference_bit_for_bit():
    """Pad rows (true lengths below the padded S) and table holes are
    dropped by the reference's scatter and land in the port's scratch
    block; the real blocks, lengths and write epochs come out
    identical."""
    lens = [7, 3, 10]
    jcfg, js, ts = _twin_pools(lens, holes=[(2, 1)])
    L, KV, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.resolved_head_dim
    S = 16                                          # padded group length
    rng = np.random.default_rng(3)
    k = rng.standard_normal((L, 3, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((L, 3, S, KV, hd)).astype(np.float32)
    js = JPK.write_tokens_batch(js, [0, 1, 2], jnp.asarray(k), jnp.asarray(v),
                                lengths=lens)
    PK.write_tokens_batch(ts, [0, 1, 2], torch.from_numpy(k),
                          torch.from_numpy(v), lengths=lens)
    np.testing.assert_array_equal(ts.k[:, :-1].numpy(), np.asarray(js.k))
    np.testing.assert_array_equal(ts.v[:, :-1].numpy(), np.asarray(js.v))
    np.testing.assert_array_equal(ts.lengths, js.lengths)
    np.testing.assert_array_equal(ts.block_epoch, js.block_epoch)
    # a second append lands after the first, still identical
    k2 = rng.standard_normal((L, 1, 2, KV, hd)).astype(np.float32)
    for st, P in ((js, JPK), (ts, PK)):
        P.allocate(st, 1, 2)
    js = JPK.write_tokens_batch(js, [1], jnp.asarray(k2), jnp.asarray(k2))
    PK.write_tokens_batch(ts, [1], torch.from_numpy(k2), torch.from_numpy(k2))
    np.testing.assert_array_equal(ts.k[:, :-1].numpy(), np.asarray(js.k))


def test_gathers_and_attention_ref_match_reference():
    lens = [7, 3, 10]
    jcfg, js, ts = _twin_pools(lens)
    L, KV, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.resolved_head_dim
    rng = np.random.default_rng(4)
    for slot, n in enumerate(lens):
        kv = rng.standard_normal((2, L, n, KV, hd)).astype(np.float32)
        js = JPK.write_tokens(js, slot, jnp.asarray(kv[0]), jnp.asarray(kv[1]))
        PK.write_tokens(ts, slot, torch.from_numpy(kv[0]),
                        torch.from_numpy(kv[1]))
    for got, want in zip(PK.gather_requests(ts, [2, 0], 12),
                         JPK.gather_requests(js, [2, 0], 12)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = rng.standard_normal((3, jcfg.num_heads, hd)).astype(np.float32)
    np.testing.assert_allclose(
        PK.paged_attention_ref(torch.from_numpy(q), ts, [0, 1, 2],
                               layer=1).numpy(),
        np.asarray(JPK.paged_attention_ref(jnp.asarray(q), js, [0, 1, 2],
                                           layer=1)),
        rtol=3e-5, atol=3e-5)
