"""Port parity, sampling: the port reproduces jax.random's threefry bits
(fold_in, random_bits, uniform) exactly, and the reference's
sample_tokens on greedy, top-k and sampled rows. The Gumbel noise is
exact too: the port's ``_xla_log`` is XLA's CPU float32 ``log`` op for
op, held bit-equal to ``jnp.log`` on 2**22 inputs over each side of 1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as JS
from repro_torch.serving import sampling as TS
from _torch_parity import one_torch_thread  # noqa: F401

SEEDS = np.array([0, 1, 7, 123456789, 2 ** 32 - 1], np.uint32)
CTRS = np.array([0, 3, 5, 1, 4_000_000_000], np.uint32)
V = 777   # odd, so the iota split is exercised past a power of two


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces JAX's random bits as JAX 0.9 draws them by
    default, with jax_threefry_partitionable on; older JAX releases need
    it set."""
    with jax.threefry_partitionable(True):
        yield


def _jax_keys():
    return [jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                  s), c)
            for s, c in zip(SEEDS, CTRS)]


def _torch_keys():
    zero = torch.zeros(len(SEEDS), dtype=torch.int64)
    return TS.fold_in(TS.fold_in((zero, zero),
                                 torch.from_numpy(SEEDS.astype(np.int64))),
                      torch.from_numpy(CTRS.astype(np.int64)))


def test_fold_in_and_random_bits_bit_exact():
    k0, k1 = _torch_keys()
    for i, key in enumerate(_jax_keys()):
        kd = np.asarray(jax.random.key_data(key)).astype(np.int64)
        assert [int(k0[i]), int(k1[i])] == list(kd)
    bits = TS.random_bits((k0, k1), V).numpy()
    for i, key in enumerate(_jax_keys()):
        want = np.asarray(jax.random.bits(key, (V,), jnp.uint32))
        np.testing.assert_array_equal(bits[i], want.astype(np.int64))


def test_uniform_bit_exact_and_gumbel_close():
    """Uniforms and Gumbel noise both bit-equal to jax.random's (the name
    predates the exact log; the assertion is equality)."""
    tiny = float(np.finfo(np.float32).tiny)
    key = _torch_keys()
    u = TS.uniform(key, V, tiny, 1.0).numpy()
    g = TS.gumbel(key, V).numpy()
    for i, jkey in enumerate(_jax_keys()):
        ju = np.asarray(jax.random.uniform(jkey, (V,), jnp.float32,
                                           minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(u[i].view(np.int32),
                                      ju.view(np.int32))
        jg = np.asarray(jax.random.gumbel(jkey, (V,), jnp.float32))
        np.testing.assert_array_equal(g[i].view(np.int32),
                                      jg.view(np.int32))


def test_xla_log_bit_equal_to_jnp_log():
    """2**22 float32 inputs log-uniform over [FLT_MIN, 1) and as many over
    (1, 3e38]; torch's own log differs from XLA's on a share of them."""
    rng = np.random.default_rng(0)
    tiny = np.finfo(np.float32).tiny
    n = 1 << 22
    below = np.exp(rng.uniform(np.log(tiny), 0.0, n)).astype(np.float32)
    above = np.exp(rng.uniform(0.0, np.log(3e38), n)).astype(np.float32)
    x = np.concatenate([np.clip(below, tiny, np.float32(1) - 2 ** -24),
                        np.clip(above, 1 + 2 ** -23, np.float32(3e38))])
    want = np.asarray(jax.jit(jnp.log)(x))
    xt = torch.from_numpy(x)
    got = TS._xla_log(xt).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (torch.log(xt).numpy() != want).any()


@pytest.mark.parametrize("max_top_k", [-1, 0, 8, 600])
def test_sample_tokens_matches_reference(max_top_k):
    """Rows: greedy, greedy with a top-k set, full-distribution sampled,
    top-k sampled (k=1 and k=8), at several temperatures; the padded
    vocab tail (V=777 of 1024 logits) must never be picked."""
    rng = np.random.default_rng(max_top_k + 2)
    B, Vp = 6, 1024
    logits = rng.standard_normal((B, Vp)).astype(np.float32) * 3
    logits[:, V:] = 50.0                        # padding rows must be masked
    temps = np.array([0.0, 0.0, 0.8, 1.0, 0.5, 2.0], np.float32)
    topks = np.array([0, 5, 0, 8, 1, 8], np.int32)
    if max_top_k == 0:
        topks[:] = 0
    seeds = np.array([3, 4, 5, 6, 7, 2 ** 32 - 2], np.uint32)
    ctrs = np.array([0, 1, 2, 30, 4, 5], np.uint32)
    stochastic = max_top_k != 8   # one case runs the greedy-only path
    kw = dict(stochastic=stochastic, max_top_k=max_top_k)
    want = np.asarray(JS.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
        jnp.asarray(seeds), jnp.asarray(ctrs), V, **kw))
    got = TS.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(topks), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(ctrs.astype(np.int64)), V, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < V).all()
