"""Port parity at the head geometries of the models served at published
widths on the card: gemma-7b (D 256, H = KV, GeGLU, tied and scaled
embedding), stablelm-12b (D 160, 4:1 GQA), llama2-13b (MHA over an odd
head count, D 128) and chameleon-34b (8:1 GQA with qk-norm, D 128), each
at 2 layers and narrow widths (``.reduced()`` with its head geometry put
back). The paged decode step (``forward_paged``, the kernel route) and
the dense prefill and decode step (``forward``, whose decode attends
through the dense-decode kernel's route) against the JAX package on the
same bridged weights; and the two decode kernels' plain versions at D 160
and 256 against the Pallas kernels in interpret mode. Tolerances: fp32
1e-4 for whole models, 3e-5 for kernels; bf16 2e-2 (relative L2 for
whole models)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.paged_decode import paged_decode_attention as pallas_paged
from repro.models import transformer as JT
from repro.serving import paged_kv as JPK
from repro_torch import configs as torch_configs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import paged_decode as PD
from repro_torch.models import transformer as TT
from repro_torch.serving import paged_kv as TPK
from _torch_parity import jit, one_torch_thread  # noqa: F401

#: arch -> its head geometry at narrow width: (H, KV, head_dim)
GEOMETRY = {
    "gemma-7b": (2, 2, 256),
    "stablelm-12b": (4, 1, 160),
    "llama2-13b": (5, 5, 128),
    "chameleon-34b": (8, 1, 128),
}
DTYPES = ("float32", "bfloat16")


def _cfgs(arch):
    """(jax cfg, port cfg): ``arch.reduced()`` with its head geometry."""
    H, KV, D = GEOMETRY[arch]
    return tuple(dataclasses.replace(mod.get_config(arch).reduced(),
                                     num_heads=H, num_kv_heads=KV, head_dim=D)
                 for mod in (jax_configs, torch_configs))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """Reference weights of ``dtype`` (bf16 cast from the one fp32 draw)
    and their bridged copy."""
    jcfg, _ = _cfgs(arch)
    if dtype == "float32":
        jp = jit(JT.init_params, jcfg, jax.random.PRNGKey(0), "float32")
    else:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    _params(arch, "float32")[0])
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _close(got, want, dtype, tol32=1e-4):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol32, atol=tol32)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 2e-2, rel


def _paged_pair(jcfg, tcfg, dtype, lens, bs=4, n_blocks=24, max_len=32):
    """Identical pools in both packages: ``lens`` tokens per slot written
    from the same numpy K/V, one block of write headroom each."""
    js = JPK.init_paged(jcfg, len(lens), n_blocks, block_size=bs, dtype=dtype,
                        max_len=max_len)
    ts = TPK.init_paged(tcfg, len(lens), n_blocks, block_size=bs, dtype=dtype,
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", sorted(GEOMETRY))
def test_forward_paged(arch, dtype):
    """One paged decode step through the kernel route (the Pallas kernel
    in interpret mode on the reference's side), on a pool with an
    inactive slot: the active rows' logits over the real vocabulary, the
    updated pools and lengths."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch, dtype)
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
                      attn_impl="kernel", interpret=True)
    got, tn, _ = TT.forward_paged(tp, tcfg, torch.from_numpy(toks), th,
                                  attn_impl="kernel")
    V = jcfg.vocab_size
    _close(got[torch.from_numpy(active), :V], np.asarray(want)[active, :V],
           dtype)
    # the real blocks: the port's pool also holds its scratch block
    _close(tn["k"][:, :-1], jn["k"], dtype)
    _close(tn["v"][:, :-1], jn["v"], dtype)
    np.testing.assert_array_equal(tn["lengths"].numpy(), jn["lengths"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", sorted(GEOMETRY))
def test_forward_dense(arch, dtype):
    """A prefill over a dense cache with a per-row last-token gather, then
    one decode step over it (the port's through the dense-decode kernel's
    route, the reference's through jnp attention): logits over the real
    vocabulary and the caches."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch, dtype)
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
    V = jcfg.vocab_size
    _close(got[..., :V], np.asarray(want)[..., :V], dtype)
    _close(tc["layers"]["k"], jc["layers"]["k"], dtype)
    nxt = rng.integers(2, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
    pos = np.full((B, 1), S, np.int32)
    want, jc, _ = jit(JT.forward, jp, jcfg, jnp.asarray(nxt),
                      positions=jnp.asarray(pos), cache=jc, mode="decode")
    got, tc, _ = TT.forward(tp, tcfg, torch.from_numpy(nxt),
                            positions=torch.from_numpy(pos), cache=tc,
                            mode="decode", attn_impl="kernel")
    _close(got[..., :V], np.asarray(want)[..., :V], dtype)
    _close(tc["layers"]["v"], jc["layers"]["v"], dtype)
    np.testing.assert_array_equal(tc["length"].numpy(), jc["length"])


def _pair(a, dtype):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


KERNEL_TOL = {"float32": 3e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KV,D", [(4, 1, 160), (2, 2, 256)],
                         ids=["d160", "d256"])
def test_paged_plain_matches_pallas_wide(H, KV, D, dtype):
    """The paged-decode kernel's plain version at D 160 (stablelm's 4:1)
    and D 256 (gemma's MHA) against the Pallas kernel in interpret mode:
    ragged rows, a length-0 row, -1 past each row's blocks."""
    rng = np.random.default_rng(D)
    lens, bs, n_blocks = [20, 0, 33, 7], 8, 16
    pool = rng.standard_normal((2, n_blocks, KV, bs, D)).astype(np.float32)
    tables = np.full((len(lens), 6), -1, np.int32)
    free = list(range(n_blocks))
    for b, n in enumerate(lens):
        for c in range(-(-n // bs)):
            tables[b, c] = free.pop()
    q = rng.standard_normal((len(lens), H, D)).astype(np.float32)
    jq, tq = _pair(q, dtype)
    (jk, tk), (jv, tv) = _pair(pool[0], dtype), _pair(pool[1], dtype)
    ln = np.asarray(lens, np.int32)
    want = jit(pallas_paged, jq, jk, jv, jnp.asarray(tables), jnp.asarray(ln),
               interpret=True)
    got = PD.paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                    torch.from_numpy(ln))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert bool((got[1] == 0).all())
    _close(got, want, "float32", KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KV,D", [(4, 1, 160), (2, 2, 256)],
                         ids=["d160", "d256"])
def test_decode_plain_matches_pallas_wide(H, KV, D, dtype):
    """The dense-decode kernel's plain version at D 160 and 256 against
    the Pallas kernel in interpret mode, ragged lengths over S 256."""
    rng = np.random.default_rng(D + 1)
    B, S = 3, 256
    jq, tq = _pair(rng.standard_normal((B, H, D)).astype(np.float32), dtype)
    (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((B, KV, S, D)).astype(np.float32), dtype)
        for _ in range(2))
    ln = np.array([1, 100, 256], np.int32)
    want = jit(pallas_decode, jq, jk, jv, jnp.asarray(ln), interpret=True)
    got = DA.decode_attention(tq, tk, tv, torch.from_numpy(ln))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, "float32", KERNEL_TOL[dtype])
