"""Port parity, SSM and hybrid families: repro_torch.models.transformer
(``ssm``: mamba2-780m, ``hybrid``: zamba2-7b) against
repro.models.transformer with the same weights (JAX init_params bridged
through numpy), and the dense cache's slot updates
(repro_torch.serving.kvcache against repro.serving.kvcache).
Tolerances: fp32 1e-4 elementwise; bf16 2e-2 relative L2 per tensor
(the two packages' bf16 matmuls round one ulp apart here and there, and
the stack carries that through its layers)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as JT
from repro.serving import kvcache as JKV
from repro_torch import configs as torch_configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.serving import kvcache as TKV
from _torch_parity import jit, one_torch_thread  # noqa: F401

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KEY = jax.random.PRNGKey(0)
#: "ssm": mamba2-780m; "hybrid": zamba2-7b (one block of 2 Mamba2 layers
#: and the shared block); "hybrid3": the same with 3 layers, so that a
#: one-layer tail runs; "dense": tinyllama-1.1b
VARIANTS = ("ssm", "hybrid", "hybrid3")


def _cfgs(variant):
    name = {"ssm": "mamba2-780m", "dense": "tinyllama-1.1b"}.get(
        variant, "zamba2-7b")
    out = []
    for mod in (jax_configs, torch_configs):
        cfg = mod.get_config(name).reduced()
        if variant == "hybrid3":
            cfg = dataclasses.replace(cfg, num_layers=3)
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def _params(jcfg, dtype):
    jp = jit(JT.init_params, jcfg, KEY, dtype)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _leaves(tree):
    """keystr path -> leaf, for a JAX tree or the port's nested dict."""
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _specs(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _leaves(tree).items()}


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if tol == TOL["bfloat16"]:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= tol, f"relative L2 error {err:.3e} > {tol}"
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _close_trees(tc, jc, tol):
    jl, tl = _leaves(jc), _leaves(tc)
    assert jl.keys() == tl.keys()
    for k, v in jl.items():
        _close(tl[k], v, tol)


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_and_cache_match_reference_trees(variant):
    """The port's own init_params and init_cache give the reference's
    keys, shapes and dtypes (bf16 weights; A_log, D, dt_bias fp32; the
    states in the cache dtype)."""
    jcfg, tcfg = _cfgs(variant)
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, KEY, "bfloat16"))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "bfloat16")
    assert _specs(tp) == _specs(jp)
    for B, M in ((3, 16), (1, 8)):
        jc = jax.eval_shape(lambda: JT.init_cache(jcfg, B, M, "bfloat16"))
        tc = TT.init_cache(tcfg, B, M, "bfloat16", "cpu")
        assert _specs(tc) == _specs(jc)


def _cache_pair(jcfg, tcfg, B, M, dtype):
    return (JT.init_cache(jcfg, B, M, dtype),
            TT.init_cache(tcfg, B, M, dtype, "cpu"))


def _step(jp, tp, jcfg, tcfg, toks, pos, jc, tc, mode, **kw):
    jpos = None if pos is None else jnp.asarray(pos)
    jl, jc, _ = jit(JT.forward, jp, jcfg, jnp.asarray(toks), jpos, jc,
                    mode=mode)
    tpos = None if pos is None else torch.from_numpy(pos)
    tl, tc, _ = TT.forward(tp, tcfg, torch.from_numpy(toks), tpos, tc,
                           mode=mode, **kw)
    return jl, jc, tl, tc


@pytest.mark.parametrize("variant,dtype", [
    ("ssm", "float32"), ("hybrid", "float32"), ("hybrid3", "float32"),
    ("hybrid", "bfloat16")])
def test_forward_prefill_decode_extend(variant, dtype):
    """Prefill over a fresh dense cache, one decode step, then a 3-token
    extension (a chunked prefill's continuation, which scans from the
    cache's states): logits and every cache leaf agree; then train-mode
    logits over the whole sequence."""
    jcfg, tcfg = _cfgs(variant)
    tol = TOL[dtype]
    jp, tp = _params(jcfg, dtype)
    rng = np.random.default_rng(0)
    B, S, M = 2, 10, 16
    toks = rng.integers(2, jcfg.vocab_size, size=(B, S + 4)).astype(np.int32)
    jc, tc = _cache_pair(jcfg, tcfg, B, M, dtype)
    jl, jc, tl, tc = _step(jp, tp, jcfg, tcfg, toks[:, :S], None, jc, tc,
                           "prefill")
    _close(tl, jl, tol)
    _close_trees(tc, jc, tol)
    for s0, n in ((S, 1), (S + 1, 3)):
        pos = np.broadcast_to(np.arange(s0, s0 + n, dtype=np.int32),
                              (B, n)).copy()
        jl, jc, tl, tc = _step(jp, tp, jcfg, tcfg, toks[:, s0:s0 + n], pos,
                               jc, tc, "decode")
        _close(tl, jl, tol)
        _close_trees(tc, jc, tol)
    jl, _, tl, _ = _step(jp, tp, jcfg, tcfg, toks, None, None, None, "train")
    _close(tl, jl, tol)


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_routes_agree_with_plain_on_cpu(variant):
    """``ssd_impl="kernel"`` (the prefill scan through ``ops.ssd``) and
    ``attn_impl="kernel"`` (a decode step's shared attention through
    ``decode_attention``) against the plain routes; on CPU tensors the
    kernels' plain versions stand in. The caches agree too."""
    _, tcfg = _cfgs(variant)
    jcfg = _cfgs(variant)[0]
    _, tp = _params(jcfg, "float32")
    rng = np.random.default_rng(1)
    B, S, M = 2, 9, 16
    toks = torch.from_numpy(
        rng.integers(2, tcfg.vocab_size, size=(B, S + 1)).astype(np.int32))
    out = {}
    for route in ("kernel", "plain"):
        kw = (dict(attn_impl="kernel", ssd_impl="kernel") if route == "kernel"
              else dict(attn_impl="gather", ssd_impl="chunked"))
        tc = TT.init_cache(tcfg, B, M, "float32", "cpu")
        pl, tc, _ = TT.forward(tp, tcfg, toks[:, :S], cache=tc,
                               mode="prefill", **kw)
        pos = torch.full((B, 1), S, dtype=torch.int32)
        dl, tc, _ = TT.forward(tp, tcfg, toks[:, S:], pos, tc, mode="decode",
                               **kw)
        out[route] = (pl, dl, tc)
    for a, b in zip(out["kernel"][:2], out["plain"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for k, v in _leaves(out["plain"][2]).items():
        torch.testing.assert_close(_leaves(out["kernel"][2])[k], v,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ("dense", "ssm", "hybrid", "hybrid3"))
def test_insert_evict_and_bytes_match_reference(variant):
    """``insert_request`` of a prefilled batch-1 cache into a slot,
    ``evict_request`` and ``cache_bytes``, against the reference's on the
    same caches, for max_batch 3 and 1 (where the whole leaf is slot
    0's)."""
    jcfg, tcfg = _cfgs(variant)
    jp, tp = _params(jcfg, "float32")
    rng = np.random.default_rng(2)
    M, S = 16, 6
    toks = rng.integers(2, jcfg.vocab_size, size=(1, S)).astype(np.int32)
    jr, tr = _cache_pair(jcfg, tcfg, 1, M, "float32")
    _, jr, _, tr = _step(jp, tp, jcfg, tcfg, toks, None, jr, tr, "prefill")
    for B, slot in ((3, 1), (1, 0)):
        jc, tc = _cache_pair(jcfg, tcfg, B, M, "float32")
        jc = JKV.insert_request(jc, slot, jr, S)
        assert TKV.insert_request(tc, slot, tr, S) is tc
        _close_trees(tc, jc, TOL["float32"])
        assert TKV.cache_bytes(tc) == JKV.cache_bytes(jc)
        jc = JKV.evict_request(jc, slot)
        assert TKV.evict_request(tc, slot) is tc
        _close_trees(tc, jc, TOL["float32"])
        for key in ("length", "positions"):
            if key in jc:
                np.testing.assert_array_equal(tc[key].numpy(),
                                              np.asarray(jc[key]))
