"""Port parity, distributed flash-decoding: ``repro_torch.parallel.
distributed_attention`` on W = 2 and 4 thread-ranks, each passing its
slice of the cache's sequence and that slice's key positions, against
the reference's ``flash_decode`` / ``flash_decode_mla`` on the whole
cache (a ``shard_map`` over the Auto 1x1 mesh), against plain attention
over the whole cache, and shard by shard against the reference's
``_local_partial`` / ``_mla_local_partial`` on the same slice. Cases: a
causal cutoff, a window, a logit softcap, a ring (key positions out of
order) and a shard whose every key is masked (its weight must be
exactly 0, not NaN)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.parallel import distributed_attention as JDA
from repro_torch.parallel import distributed_attention as DA
from _torch_mesh import auto_mesh, run_mesh
from _torch_parity import one_torch_thread  # noqa: F401

B, H, KV, D, M = 2, 4, 2, 16, 16
R_LAT, RO = 24, 8
TOL = 3e-5
# case -> (query positions [B], key positions [B, M], window, softcap)
_ring = np.array([(16 + i if i < 6 else i) for i in range(M)], np.int32)
CASES = {
    "causal": ([15, 11], np.arange(M), None, 0.0),
    "window": ([15, 13], np.arange(M), 6, 0.0),
    "softcap": ([15, 9], np.arange(M), None, 4.0),
    "ring": ([21, 20], _ring, M, 0.0),
    "masked_shard": ([2, 3], np.arange(M), None, 0.0),
}
MESHES = {2: ((1, 2), "model"), 4: ((4, 1), "data")}


def _inputs(case, mla=False):
    qpos, kpos, window, softcap = CASES[case]
    rng = np.random.default_rng(len(case))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qp = np.array(qpos, np.int32)[:, None]
    kp = np.broadcast_to(kpos.astype(np.int32), (B, M)).copy()
    if mla:
        arrays = (f(B, 1, H, R_LAT), f(B, 1, H, RO), f(B, M, R_LAT),
                  f(B, M, RO))
    else:
        arrays = (f(B, 1, H, D) * 2.0, f(B, M, KV, D), f(B, M, KV, D))
    return arrays, qp, kp, window, softcap


def _shard(a, r, W):
    return a[:, r * (M // W):(r + 1) * (M // W)]


@functools.cache
def _ref_gqa(case):
    """The reference on one case, under one jit: ``flash_decode`` over
    the whole cache, plain attention, and each shard's partial at W = 2
    and 4 (by W, a list by shard)."""
    (q, k, v), qp, kp, window, softcap = _inputs(case)

    def run():
        sharded = JDA.flash_decode(q, k, v, qp, kp, mesh=auto_mesh(),
                                   window=window, softcap=softcap)
        plain = JL.attention(q, k, v, q_positions=qp, k_positions=kp,
                             window=window, softcap=softcap)
        qg = q.reshape(B, 1, KV, H // KV, D)
        parts = {W: [JDA._local_partial(qg, _shard(k, r, W), _shard(v, r, W),
                                        qp, _shard(kp, r, W), window, softcap)
                     for r in range(W)] for W in MESHES}
        return sharded, plain, parts

    with jax.set_mesh(auto_mesh()):
        return jax.tree_util.tree_map(np.asarray, jax.jit(run)())


@functools.cache
def _ref_mla(case, qk_dim=40):
    """As ``_ref_gqa`` for ``flash_decode_mla``; the plain attention is
    ``apply_mla_decode``'s absorbed form over the whole cache."""
    (ql, qr, c, kr), qp, kp, window, _ = _inputs(case, mla=True)

    def run():
        sharded = JDA.flash_decode_mla(ql, qr, c, kr, qp, kp,
                                       mesh=auto_mesh(), window=window,
                                       qk_dim=qk_dim)
        s = (jnp.einsum("bshr,btr->bhst", ql, c)
             + jnp.einsum("bshk,btk->bhst", qr, kr)) / np.sqrt(qk_dim)
        mask = JL._attn_mask(qp, kp, None, window, True)
        w = jax.nn.softmax(jnp.where(mask[:, None], s, JL.NEG_INF), axis=-1)
        plain = jnp.einsum("bhst,btr->bshr", w, c)
        parts = {W: [JDA._mla_local_partial(
            ql[:, 0], qr[:, 0], _shard(c, r, W), _shard(kr, r, W), qp,
            _shard(kp, r, W), window, 1 / np.sqrt(qk_dim))
            for r in range(W)] for W in MESHES}
        return sharded, plain, parts

    with jax.set_mesh(auto_mesh()):
        return jax.tree_util.tree_map(np.asarray, jax.jit(run)())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("W", [2, 4])
def test_flash_decode(case, W):
    (q, k, v), qp, kp, window, softcap = _inputs(case)
    sharded, plain, parts = _ref_gqa(case)
    shape, axis = MESHES[W]

    def rank(mesh):
        r = mesh.axis_index(axis)
        ks, vs, kps = (torch.from_numpy(_shard(a, r, W).copy())
                       for a in (k, v, kp))
        qt, qpt = torch.from_numpy(q), torch.from_numpy(qp)
        part = DA._local_partial(qt.reshape(B, 1, KV, H // KV, D), ks, vs,
                                 qpt, kps, window, softcap)
        out = DA.flash_decode(qt, ks, vs, qpt, kps, mesh=mesh, seq_axis=axis,
                              window=window, softcap=softcap)
        # the partials of the one query row (their row axis is 3)
        return (r, [t.select(3, 0).numpy() for t in part], out.numpy(),
                dict(mesh.collectives))

    masked = 0
    for r, part, out, colls in run_mesh(shape, rank):
        np.testing.assert_allclose(out, sharded, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out, plain, rtol=TOL, atol=TOL)
        for got, ref in zip(part, parts[W][r]):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL,
                                       atol=TOL)
        # a shard with no key in range: m = NEG_INF, l = its length
        dead = (part[0] == JL.NEG_INF).all(axis=(1, 2))
        masked += int(dead.sum())
        assert (part[1][dead] == M // W).all()
        assert colls == {"all-reduce": 3}
    assert np.isfinite(out).all()
    if case == "masked_shard":
        assert masked > 0


@pytest.mark.parametrize("case", ["causal", "window", "ring",
                                  "masked_shard"])
@pytest.mark.parametrize("W", [2, 4])
def test_flash_decode_mla(case, W):
    (ql, qr, c, kr), qp, kp, window, _ = _inputs(case, mla=True)
    sharded, plain, parts = _ref_mla(case)
    shape, axis = MESHES[W]

    def rank(mesh):
        r = mesh.axis_index(axis)
        cs, krs, kps = (torch.from_numpy(_shard(a, r, W).copy())
                        for a in (c, kr, kp))
        qlt, qrt, qpt = (torch.from_numpy(a) for a in (ql, qr, qp))
        part = DA._mla_local_partial(qlt, qrt, cs, krs, qpt, kps, window,
                                     1 / np.sqrt(40))
        out = DA.flash_decode_mla(qlt, qrt, cs, krs, qpt, kps, mesh=mesh,
                                  seq_axis=axis, window=window, qk_dim=40)
        # the partials of the one query row (their row axis is 2)
        return r, [t.select(2, 0).numpy() for t in part], out.numpy()

    for r, part, out in run_mesh(shape, rank):
        np.testing.assert_allclose(out, sharded, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out, plain, rtol=TOL, atol=TOL)
        for got, ref in zip(part, parts[W][r]):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL,
                                       atol=TOL)
        assert np.isfinite(out).all()
