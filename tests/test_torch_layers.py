"""Port parity, model primitives: repro_torch.models.layers against
repro.models.layers on the same numpy inputs and the same (bridged)
weights. Tolerances: fp32 3e-5, bf16 2e-2 (einsum orders differ between
XLA and torch; bf16 rounds at different places)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from _torch_parity import jit, one_torch_thread  # noqa: F401

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
KEY = jax.random.PRNGKey(0)


def _cfgs(gqa=False, **changes):
    """(jax cfg, port cfg): reduced tinyllama, or its H=8/KV=2 variant."""
    out = []
    for get in (jax_config, get_config):
        cfg = get("tinyllama-1.1b").reduced()
        if gqa:
            cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=2)
        out.append(dataclasses.replace(cfg, **changes))
    return out


def _j(a, dtype):
    return jnp.asarray(a, dtype)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                  dtype))



def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_sinusoids(dtype):
    tol = TOL[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 256, size=(2, 5)).astype(np.int32)
    for kind in ("rmsnorm", "layernorm"):
        jcfg, tcfg = _cfgs(norm_kind=kind, d_model=64)
        jp = JL.init_norm(jcfg, jnp.float32)
        jp = {k: v + _j(rng.standard_normal(v.shape), jnp.float32)
              for k, v in jp.items()}
        tp = _bridge(jp)
        _close(TL.apply_norm(tp, _t(x, dtype), tcfg),
               jit(JL.apply_norm, jp, _j(x, dtype), jcfg), tol)
    _close(TL.rms_norm_dim(_t(x, dtype)),
           jit(JL.rms_norm_dim, _j(x, dtype)), tol)
    _close(TL.apply_rope(_t(x, dtype), torch.from_numpy(pos), 10_000.0),
           jit(JL.apply_rope, _j(x, dtype), jnp.asarray(pos), 10_000.0), tol)
    _close(TL.sinusoidal_positions(torch.from_numpy(pos), 64),
           jit(JL.sinusoidal_positions, jnp.asarray(pos), 64), 3e-5)


ATTN_CASES = {
    "causal": {},
    "window": {"window": 5},
    "kv_len": {"kv_len": [9, 4]},
    "k_positions": {"k_positions": "ring"},
    "softcap": {"softcap": 2.0},
    "non_causal": {"causal": False},
    "chunked": {"chunk": 4},          # Sq > chunk: the chunk loop
}


@pytest.mark.parametrize("case,dtype",
                         [(c, "float32") for c in sorted(ATTN_CASES)]
                         + [("window", "bfloat16")])
def test_attention_masks(case, dtype):
    """Chunked fp32 attention, GQA-grouped (H=8 over KV=2), every mask."""
    kw = dict(ATTN_CASES[case])
    rng = np.random.default_rng(1)
    B, Sq, Sk, H, KV, D = 2, 10, 12, 8, 2, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    qpos = np.stack([np.arange(2, 2 + Sq)] * B).astype(np.int32)
    jkw, tkw = {}, {}
    for name, val in kw.items():
        if name == "kv_len":
            jkw[name] = jnp.asarray(val, jnp.int32)
            tkw[name] = torch.tensor(val, dtype=torch.int32)
        elif name == "k_positions":
            kpos = np.stack([(np.arange(Sk) + 3 * b) % Sk for b in range(B)])
            jkw[name] = jnp.asarray(kpos, jnp.int32)
            tkw[name] = torch.from_numpy(kpos.astype(np.int32))
        else:
            jkw[name] = tkw[name] = val
    want = jit(JL.attention, _j(q, dtype), _j(k, dtype), _j(v, dtype),
                        q_positions=jnp.asarray(qpos), **jkw)
    got = TL.attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                       q_positions=torch.from_numpy(qpos), **tkw)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])


def _cache_pair(jcfg, B, M, dtype, rng, filled):
    """A dense per-layer cache with ``filled[b]`` rows written, both
    packages, plus the full init_cache dicts (for _cache_meta)."""
    hd, KV = jcfg.resolved_head_dim, jcfg.num_kv_heads
    k = rng.standard_normal((B, M, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, M, KV, hd)).astype(np.float32)
    pos = np.full((B, M), 2 ** 30, np.int32)
    for b, n in enumerate(filled):
        pos[b, :n] = np.arange(n)
    jc = {"k": _j(k, dtype), "v": _j(v, dtype)}
    tc = {"k": _t(k, dtype), "v": _t(v, dtype)}
    return jc, tc, pos


@pytest.mark.parametrize("mode,dtype", [
    ("train", "float32"), ("prefill", "float32"), ("decode", "float32"),
    ("prefill", "bfloat16"), ("decode", "bfloat16")])
def test_apply_gqa(mode, dtype):
    """Train path, and the cache path with attend_fresh on (prefill) and
    off (decode), GQA-grouped (H=8 over KV=2); the written cache is
    compared too. R = 1 runs in test_torch_model."""
    jcfg, tcfg = _cfgs(True)
    tol = TOL[dtype]
    jp = jit(JL.init_gqa, jcfg, KEY, getattr(jnp, dtype))
    tp = _bridge(jp)
    rng = np.random.default_rng(2)
    B, M = 2, 16
    S = 1 if mode == "decode" else 6
    start = np.array([9, 4]) if mode == "decode" else np.zeros(2, int)
    positions = (start[:, None] + np.arange(S)[None, :]).astype(np.int32)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    if mode == "train":
        want, _ = jit(JL.apply_gqa, jp, _j(x, dtype), jcfg,
                               positions=jnp.asarray(positions))
        got, cache = TL.apply_gqa(tp, _t(x, dtype), tcfg,
                                  positions=torch.from_numpy(positions))
        assert cache is None
        _close(got, want, tol)
        return
    jc, tc, kpos0 = _cache_pair(jcfg, B, M, dtype, rng, start)
    jmeta = jit(JT._cache_meta, {"positions": jnp.asarray(kpos0)},
                           jnp.asarray(positions))
    tmeta = TT._cache_meta({"positions": torch.from_numpy(kpos0.copy())},
                           torch.from_numpy(positions))
    want, wc = jit(JL.apply_gqa, jp, _j(x, dtype), jcfg,
                            positions=jnp.asarray(positions), cache=jc,
                            slots=jmeta[0], k_positions=jmeta[1],
                            attend_fresh=(mode == "prefill"))
    got, gc = TL.apply_gqa(tp, _t(x, dtype), tcfg,
                           positions=torch.from_numpy(positions), cache=tc,
                           slots=tmeta[0], k_positions=tmeta[1],
                           attend_fresh=(mode == "prefill"))
    _close(got, want, tol)
    _close(gc["k"], wc["k"], tol)
    _close(gc["v"], wc["v"], tol)


def _pool_pair(jcfg, dtype, rng, n_blocks=12, bs=4, B=3, width=5):
    """Pools of ``n_blocks`` real blocks and the port's scratch block
    last (the reference takes ``pool[:, :n_blocks]``)."""
    KV, hd = jcfg.num_kv_heads, jcfg.resolved_head_dim
    pool = rng.standard_normal((2, n_blocks + 1, KV, bs, hd)).astype(
        np.float32)
    tables = np.full((B, width), -1, np.int32)
    tables[0, :3] = [4, 7, 1]
    tables[1, :1] = [9]
    tables[2, :4] = [0, 2, 3, 11]
    lengths = np.array([10, 3, 12], np.int32)  # write heads: cols 2, 0, 3
    return pool, tables, lengths


@pytest.mark.parametrize("gqa,impl,dtype", [
    (True, "gather", "float32"), (True, "kernel", "float32"),
    (True, "gather", "bfloat16"), (True, "kernel", "bfloat16"),
    (False, "kernel", "float32")])
def test_apply_gqa_paged(gqa, impl, dtype):
    """Write-then-attend over a block pool, both impls (the port's
    "kernel" is the plain version on the CPU, the reference's the Pallas
    kernel in interpret mode); an inactive row writes nothing."""
    jcfg, tcfg = _cfgs(gqa)
    tol = TOL[dtype]
    jp = jit(JL.init_gqa, jcfg, KEY, getattr(jnp, dtype))
    tp = _bridge(jp)
    rng = np.random.default_rng(3)
    pool, tables, lengths = _pool_pair(jcfg, dtype, rng)
    active = np.array([True, False, True])
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    positions = lengths[:, None]
    want, wk, wv = jit(
        JL.apply_gqa_paged,
        jp, _j(x, dtype), jcfg, positions=jnp.asarray(positions),
        pool_k=_j(pool[0, :-1], dtype), pool_v=_j(pool[1, :-1], dtype),
        block_tables=jnp.asarray(tables), active=jnp.asarray(active),
        impl=impl, interpret=True)
    got, gk, gv = TL.apply_gqa_paged(
        tp, _t(x, dtype), tcfg, positions=torch.from_numpy(positions),
        pool_k=_t(pool[0], dtype), pool_v=_t(pool[1], dtype),
        block_tables=torch.from_numpy(tables),
        active=torch.from_numpy(active), impl=impl)
    _close(got[torch.from_numpy(active)], np.asarray(want, np.float32)[active],
           tol)
    _close(gk[:-1], wk, tol)
    _close(gv[:-1], wv, tol)


def test_apply_gqa_paged_softcap_window_route_to_gather():
    """Softcap archs and sliding windows take the gather path even when
    the kernel is asked for — same numbers as the reference's gather."""
    jcfg, tcfg = _cfgs(True, logit_softcap=3.0)
    jp = jit(JL.init_gqa, jcfg, KEY, jnp.float32)
    tp = _bridge(jp)
    rng = np.random.default_rng(4)
    pool, tables, lengths = _pool_pair(jcfg, "float32", rng)
    active = np.ones(3, bool)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    for window in (None, 6):
        want, _, _ = jit(
            JL.apply_gqa_paged,
            jp, jnp.asarray(x), jcfg, positions=jnp.asarray(lengths[:, None]),
            pool_k=jnp.asarray(pool[0, :-1]),
            pool_v=jnp.asarray(pool[1, :-1]),
            block_tables=jnp.asarray(tables), active=jnp.asarray(active),
            window=window, impl="gather")
        got, _, _ = TL.apply_gqa_paged(
            tp, torch.from_numpy(x), tcfg,
            positions=torch.from_numpy(lengths[:, None]),
            pool_k=torch.from_numpy(pool[0].copy()),
            pool_v=torch.from_numpy(pool[1].copy()),
            block_tables=torch.from_numpy(tables),
            active=torch.from_numpy(active), window=window, impl="kernel")
        _close(got, want, 3e-5)


@pytest.mark.parametrize("ffn,dtype", [
    ("swiglu", "float32"), ("geglu", "float32"), ("gelu", "float32"),
    ("swiglu", "bfloat16"), ("geglu", "bfloat16"), ("gelu", "bfloat16")])
def test_apply_mlp(ffn, dtype):
    jcfg, tcfg = _cfgs(ffn_kind=ffn)
    jp = jit(JL.init_mlp, jcfg, KEY, getattr(jnp, dtype))
    tp = _bridge(jp)
    x = np.random.default_rng(5).standard_normal(
        (2, 3, jcfg.d_model)).astype(np.float32)
    _close(TL.apply_mlp(tp, _t(x, dtype), tcfg),
           jit(JL.apply_mlp, jp, _j(x, dtype), jcfg), TOL[dtype])


def _gelu_draws(dtype):
    """10^5 seeded inputs (wide enough to reach gelu's flat tails) and
    cotangents, as (numpy, jax, torch) of ``dtype``."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(100_000) * 3).astype(np.float32)
    g = rng.standard_normal(100_000).astype(np.float32)
    return x, g, _j(x, dtype), _j(g, dtype), _t(x, dtype), _t(g, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    """``layers._gelu`` is XLA's op chain of ``jax.nn.gelu``: bf16 bit for
    bit (torch's fused gelu differs in 42.8% of bf16 outputs), fp32
    within 3e-5."""
    *_, jx, _, tx, _ = _gelu_draws(dtype)
    got = TL._gelu(tx).float().numpy()
    want = np.asarray(jax.jit(jax.nn.gelu)(jx).astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_backward_is_jax_vjp(dtype):
    """``layers._gelu``'s gradient equals ``jax.vjp`` of ``jax.nn.gelu``:
    bf16 bit for bit (autograd through the chain's ops differs in 47.5%
    of them), fp32 within 3e-5."""
    *_, jx, jg, tx, tg = _gelu_draws(dtype)
    want = jax.jit(lambda x, g: jax.vjp(jax.nn.gelu, x)[1](g)[0])(jx, jg)
    want = np.asarray(want.astype(jnp.float32))
    tx.requires_grad_()
    (got,) = torch.autograd.grad(TL._gelu(tx), tx, tg)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype],
                                   atol=TOL[dtype])


def test_draw_holds_one_layer_slice():
    """A stacked leaf is drawn a layer's slice at a time into its own
    dtype: the draw's peak (``launch.dryrun.MemoryTally``) is the bf16
    result plus one fp32 ``[in, out]`` slice, where a whole-leaf fp32
    draw held the result plus two fp32 copies of the stack; the values
    are one whole in-place draw's on the CPU (the generator is read in
    the same order), scaled by the fan-in."""
    from repro_torch.launch.dryrun import MemoryTally

    L, d_in, d_out = 6, 384, 1024
    gen = torch.Generator().manual_seed(0)
    with MemoryTally((torch.empty(0),)) as tally:
        w = TL.dense_init(gen, d_in, d_out, torch.bfloat16, lead=(L,))
    result = L * d_in * d_out * 2
    assert tally.peak - tally.base <= result + d_in * d_out * 4
    whole = torch.empty(L * d_in, d_out)
    TL.truncated_normal_(whole, torch.Generator().manual_seed(0))
    want = (whole * (1.0 / d_in ** 0.5)).bfloat16().view(L, d_in, d_out)
    assert torch.equal(w, want)


def test_truncated_normal_matches_jax_moments():
    """``truncated_normal_`` against ``jax.random.truncated_normal(-2, 2)``
    on 2^20 draws each: both within [-2, 2], and their means, standard
    deviations, fourth moments and quantiles agree within a few standard
    errors of the sample (the truncated unit normal's std is 0.8796)."""
    n = 1 << 20
    got = TL.truncated_normal_(torch.empty(n), torch.Generator().manual_seed(0))
    got = got.double().numpy()
    want = np.asarray(jax.random.truncated_normal(KEY, -2.0, 2.0, (n,)),
                      np.float64)
    for x in (got, want):
        assert np.abs(x).max() <= 2.0
        assert abs(x.std() / 0.8796 - 1) < 2e-3
    se = 0.8796 / n ** 0.5
    assert abs(got.mean() - want.mean()) < 6 * se
    assert abs(got.std() - want.std()) < 6 * se
    assert abs((got ** 4).mean() - (want ** 4).mean()) < 6e-3
    qs = [0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99]
    np.testing.assert_allclose(np.quantile(got, qs), np.quantile(want, qs),
                               atol=6e-3)


def test_init_shapes_match_reference():
    """The port's own initialisers give the reference tree's shapes and
    the same scale (fan-in truncated normal)."""
    jcfg, tcfg = _cfgs(True)
    gen = torch.Generator().manual_seed(0)
    tp = TL.init_gqa(tcfg, gen, torch.float32, lead=(3,))
    jp = jit(JL.stack_init, lambda k: JL.init_gqa(jcfg, k, jnp.float32), KEY, 3)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape
        assert abs(float(tp[name].std()) - float(jnp.std(jp[name]))) < 0.01
