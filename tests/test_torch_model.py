"""Port parity, model level: repro_torch.models.transformer against
repro.models.transformer with the same weights (JAX init_params bridged
through numpy), plus the weight bridge and the copied configs.
Tolerances: fp32 1e-4, bf16 2e-2."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as JT
from repro.serving import paged_kv as JPK
from repro_torch import configs as torch_configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.serving import paged_kv as TPK
from _torch_parity import jit, one_torch_thread  # noqa: F401

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KEY = jax.random.PRNGKey(0)



def _cfgs(variant):
    """"reduced" / "gqa": tinyllama; "vlm": chameleon; "moe": qwen2-moe
    (4 experts, the dense dispatch); "moe12": the same with 12 experts
    (padded to 16, the scatter dispatch)."""
    out = []
    for mod in (jax_configs, torch_configs):
        name = {"vlm": "chameleon-34b", "moe": "qwen2-moe-a2.7b",
                "moe12": "qwen2-moe-a2.7b"}.get(variant, "tinyllama-1.1b")
        cfg = mod.get_config(name).reduced()
        if variant == "gqa":
            cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=2)
        if variant == "moe12":
            cfg = dataclasses.replace(cfg, num_experts=12)
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def _params(jcfg, dtype):
    """Reference weights and their bridged copy, shared by the tests of
    one (config, dtype); tests never modify weights."""
    jp = jit(JT.init_params, jcfg, KEY, dtype)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_configs_match_reference():
    """Every copied config equals the reference field by field, and so do
    the derived properties and the reduced variant."""
    assert torch_configs.list_archs() == jax_configs.list_archs()
    assert torch_configs.ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS
    for name in jax_configs.list_archs():
        j, t = jax_configs.get_config(name), torch_configs.get_config(name)
        for a, b in ((j, t), (j.reduced(), t.reduced())):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            assert (a.padded_vocab, a.supports_paged_kv,
                    a.resolved_head_dim, a.param_count()) == \
                (b.padded_vocab, b.supports_paged_kv, b.resolved_head_dim,
                 b.param_count()), name


def test_bridge_round_trip():
    """bf16 goes through float32 exactly; keys, shapes and the stacked
    [L, ...] layout are kept; an explicit dtype casts every leaf."""
    jcfg, _ = _cfgs("gqa")
    jp, _ = _params(jcfg, "bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jp))[0]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for path, arr in flat:
        t = tp
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == arr.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      arr.astype(np.float32))
    t32 = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                            dtype=torch.float32)
    assert t32["layers"]["attn"]["wq"].dtype == torch.float32
    assert t32["layers"]["attn"]["wq"].shape[0] == jcfg.num_layers


def test_port_init_matches_reference_tree():
    """The port's own init_params gives the reference's keys and shapes."""
    jcfg, tcfg = _cfgs("gqa")
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, KEY, "float32"))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "float32")
    jshapes = {jax.tree_util.keystr(k): v.shape for k, v in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    tshapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in tflat}
    assert jshapes == tshapes


@pytest.mark.parametrize("variant,dtype", [
    ("reduced", "float32"), ("gqa", "float32"), ("gqa", "bfloat16"),
    ("vlm", "float32")])
def test_forward_prefill_then_decode(variant, dtype):
    """Prefill over a dense cache with a per-row last_idx gather, then a
    decode step over the written cache: logits and caches agree."""
    jcfg, tcfg = _cfgs(variant)
    tol = TOL[dtype]
    jp, tp = _params(jcfg, dtype)
    rng = np.random.default_rng(0)
    B, S, M = 2, 12, 16
    toks = rng.integers(2, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    last = np.array([S - 1, 7], np.int32)
    jc = JT.init_cache(jcfg, B, M, dtype)
    tc = TT.init_cache(tcfg, B, M, dtype, "cpu")
    want, jc, _ = jit(JT.forward, jp, jcfg, jnp.asarray(toks), cache=jc,
                       mode="prefill", last_idx=jnp.asarray(last))
    got, tc, _ = TT.forward(tp, tcfg, torch.from_numpy(toks), cache=tc,
                            mode="prefill", last_idx=torch.from_numpy(last))
    _close(got, want, tol)
    _close(tc["layers"]["k"], jc["layers"]["k"], tol)
    np.testing.assert_array_equal(tc["positions"].numpy(), jc["positions"])

    nxt = rng.integers(2, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos = np.full((B, 1), S, np.int32)
    want, jc, _ = jit(JT.forward, jp, jcfg, jnp.asarray(nxt),
                       positions=jnp.asarray(pos), cache=jc, mode="decode")
    got, tc, _ = TT.forward(tp, tcfg, torch.from_numpy(nxt),
                            positions=torch.from_numpy(pos), cache=tc,
                            mode="decode")
    _close(got, want, tol)
    _close(tc["layers"]["v"], jc["layers"]["v"], tol)
    np.testing.assert_array_equal(tc["length"].numpy(), jc["length"])


def test_forward_train_and_ring_buffer_prefill():
    """Train logits over the whole sequence, and a prefill longer than
    its cache (the ring buffer keeps the last M tokens; the reference
    drops the rest, the port never writes them)."""
    jcfg, tcfg = _cfgs("gqa")
    jp, tp = _params(jcfg, "float32")
    toks = np.random.default_rng(1).integers(
        2, jcfg.vocab_size, size=(2, 10)).astype(np.int32)
    want, _, _ = jit(JT.forward, jp, jcfg, jnp.asarray(toks))
    got, _, _ = TT.forward(tp, tcfg, torch.from_numpy(toks))
    _close(got, want, 1e-4)
    jc = JT.init_cache(jcfg, 2, 8, "float32")
    tc = TT.init_cache(tcfg, 2, 8, "float32", "cpu")
    want, jc, _ = jit(JT.forward, jp, jcfg, jnp.asarray(toks), cache=jc,
                       mode="prefill", window=8)
    got, tc, _ = TT.forward(tp, tcfg, torch.from_numpy(toks), cache=tc,
                            mode="prefill", window=8)
    _close(got, want, 1e-4)
    _close(tc["layers"]["k"], jc["layers"]["k"], 1e-4)
    np.testing.assert_array_equal(tc["positions"].numpy(), jc["positions"])


def _paged_pair(jcfg, tcfg, dtype, lens, bs=4, n_blocks=24, max_len=32):
    """Identical pools in both packages: ``lens`` tokens per slot written
    from the same numpy K/V, one block of write headroom each."""
    B = len(lens)
    js = JPK.init_paged(jcfg, B, n_blocks, block_size=bs, dtype=dtype,
                        max_len=max_len)
    ts = TPK.init_paged(tcfg, B, n_blocks, block_size=bs, dtype=dtype,
                        max_len=max_len, device="cpu")
    rng = np.random.default_rng(2)
    L, KV, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.resolved_head_dim
    for slot, n in enumerate(lens):
        kv = rng.standard_normal((2, L, n, KV, hd)).astype(np.float32)
        for st, PK, conv in ((js, JPK, lambda a: jnp.asarray(a, dtype)),
                             (ts, TPK, lambda a: torch.from_numpy(a).to(
                                 getattr(torch, dtype)))):
            PK.allocate(st, slot, n + 1)
            if n:
                PK.write_tokens(st, slot, conv(kv[0]), conv(kv[1]))
    return js, ts


@pytest.mark.parametrize("variant,dtype,impl", [
    ("reduced", "float32", "gather"), ("gqa", "float32", "kernel"),
    ("gqa", "bfloat16", "kernel")])
def test_forward_paged(variant, dtype, impl):
    """One paged decode step (write-then-attend into the pool) against
    the reference, on a pool with an inactive slot: logits of the active
    rows, the updated pools and lengths agree."""
    jcfg, tcfg = _cfgs(variant)
    tol = TOL[dtype]
    jp, tp = _params(jcfg, dtype)
    lens = [9, 0, 14]
    js, ts = _paged_pair(jcfg, tcfg, dtype, lens)
    active = np.array([n > 0 for n in lens])
    toks = np.array([[5], [0], [9]], np.int32)
    jh = {"k": js.k, "v": js.v, "block_tables": jnp.asarray(js.block_tables),
          "lengths": jnp.asarray(js.lengths), "active": jnp.asarray(active)}
    th = {"k": ts.k, "v": ts.v,
          "block_tables": torch.from_numpy(ts.block_tables),
          "lengths": torch.from_numpy(ts.lengths),
          "active": torch.from_numpy(active)}
    want, jn, _ = jit(JT.forward_paged, jp, jcfg, jnp.asarray(toks), jh,
                       attn_impl=impl, interpret=True)
    got, tn, _ = TT.forward_paged(tp, tcfg, torch.from_numpy(toks), th,
                                  attn_impl=impl)
    _close(got[torch.from_numpy(active)], np.asarray(want)[active], tol)
    # the real blocks: the port's pool also holds its scratch block
    _close(tn["k"][:, :-1], jn["k"], tol)
    _close(tn["v"][:, :-1], jn["v"], tol)
    np.testing.assert_array_equal(tn["lengths"].numpy(), jn["lengths"])


@pytest.mark.parametrize("variant", ["moe", "moe12"])
def test_moe_forward_modes(variant):
    """Reduced qwen2-moe through train, prefill and decode over a dense
    cache and one paged decode step: logits within 1e-4 and the aux loss
    (summed over layers) within 1e-5 in every mode."""
    jcfg, tcfg = _cfgs(variant)
    jp, tp = _params(jcfg, "float32")
    rng = np.random.default_rng(3)
    toks = rng.integers(2, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    nxt = rng.integers(2, jcfg.vocab_size, size=(2, 1)).astype(np.int32)

    def check(want, got):
        _close(got[0], want[0], 1e-4)
        assert abs(float(got[2]) - float(want[2])) <= 1e-5
        assert float(got[2]) > 0

    check(jit(JT.forward, jp, jcfg, jnp.asarray(toks)),
          TT.forward(tp, tcfg, torch.from_numpy(toks)))
    jc = JT.init_cache(jcfg, 2, 16, "float32")
    tc = TT.init_cache(tcfg, 2, 16, "float32", "cpu")
    want = jit(JT.forward, jp, jcfg, jnp.asarray(toks), cache=jc,
               mode="prefill")
    got = TT.forward(tp, tcfg, torch.from_numpy(toks), cache=tc,
                     mode="prefill")
    check(want, got)
    pos = np.full((2, 1), 12, np.int32)
    check(jit(JT.forward, jp, jcfg, jnp.asarray(nxt),
              positions=jnp.asarray(pos), cache=want[1], mode="decode"),
          TT.forward(tp, tcfg, torch.from_numpy(nxt),
                     positions=torch.from_numpy(pos), cache=got[1],
                     mode="decode"))
    lens = [9, 0, 14]
    js, ts = _paged_pair(jcfg, tcfg, "float32", lens)
    active = np.array([n > 0 for n in lens])
    toks = np.array([[5], [0], [9]], np.int32)
    jh = {"k": js.k, "v": js.v, "block_tables": jnp.asarray(js.block_tables),
          "lengths": jnp.asarray(js.lengths), "active": jnp.asarray(active)}
    th = {"k": ts.k, "v": ts.v,
          "block_tables": torch.from_numpy(ts.block_tables),
          "lengths": torch.from_numpy(ts.lengths),
          "active": torch.from_numpy(active)}
    want = jit(JT.forward_paged, jp, jcfg, jnp.asarray(toks), jh)
    got = TT.forward_paged(tp, tcfg, torch.from_numpy(toks), th,
                           attn_impl="kernel")
    # the inactive row's garbage takes part in the routing (and in the
    # aux loss) in both packages
    check((np.asarray(want[0])[active], None, want[2]),
          (got[0][torch.from_numpy(active)], None, got[2]))
    _close(got[1]["k"][:, :-1], want[1]["k"], 1e-4)


def test_unknown_family_raises():
    """Every family of the reference is ported (MLA and audio have their
    own parity tests, tests/test_torch_mla.py and test_torch_audio.py);
    only a family the reference does not know either is refused."""
    cfg = dataclasses.replace(
        torch_configs.get_config("tinyllama-1.1b").reduced(), family="rnn")
    with pytest.raises(ValueError, match="unknown family rnn"):
        TT.init_params(cfg, torch.Generator().manual_seed(0), "float32")
    with pytest.raises(ValueError, match="unknown family rnn"):
        TT.init_cache(cfg, 1, 8, "float32", "cpu")


@pytest.mark.parametrize("arch", torch_configs.list_archs())
def test_init_draw_keeps_shapes_and_scale(arch, monkeypatch):
    """Every config's ``.reduced()`` tree from the port's own draw, with
    ``DRAW_ELEMS`` lowered so that every leaf is drawn in chunks of 16
    rows (a layer's slice or less): the reference's keys, shapes and
    types (``jax.eval_shape``), every ``dense_init`` leaf a fan-in
    truncated normal (within [-2, 2] / sqrt(fan_in), std 0.8796 /
    sqrt(fan_in), the truncated unit normal's, within 5% over the tree)
    and the embedding a normal of std 1 / sqrt(d_model)."""
    from repro_torch.models import layers as TL
    from repro_torch.models import ssm as TS

    draws, rows, chunks = [], [], []
    dense_init, truncated_normal_ = TL.dense_init, TL.truncated_normal_

    def recording(gen, in_dim, out_shape, dtype, *, lead=()):
        w = dense_init(gen, in_dim, out_shape, dtype, lead=lead)
        draws.append((in_dim, w))
        rows.append(w.numel() // math.prod(np.atleast_1d(out_shape)))
        return w

    def chunk(t, gen):
        chunks.append(t.shape[0])
        return truncated_normal_(t, gen)

    monkeypatch.setattr(TL, "DRAW_ELEMS", 256)
    monkeypatch.setattr(TL, "truncated_normal_", chunk)
    monkeypatch.setattr(TL, "dense_init", recording)
    monkeypatch.setattr(TS, "dense_init", recording)
    jcfg = jax_configs.get_config(arch).reduced()
    tcfg = torch_configs.get_config(arch).reduced()
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, KEY, "bfloat16"))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "bfloat16")
    jleaves = {jax.tree_util.keystr(k): (v.shape, str(v.dtype)) for k, v in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    tleaves = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
               for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert tleaves == jleaves
    assert draws
    assert max(chunks) <= 16
    assert sum(chunks) == sum(rows)
    unit = torch.cat([(w.float() * in_dim ** 0.5).flatten()
                      for in_dim, w in draws])
    assert float(unit.abs().max()) <= 2.0 * (1 + 2 ** -7)
    assert abs(float(unit.std()) / 0.8796 - 1) < 0.05
    embed = tp["embed"].float() * tcfg.d_model ** 0.5
    assert abs(float(embed.std()) - 1) < 0.05
