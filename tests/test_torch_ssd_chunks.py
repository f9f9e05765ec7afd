"""Port parity, chunk-parallel SSD scan: the plain PyTorch model of the SSD
kernel's three passes (``ssd_scan_chunked_ref``: chunk states, state
passing, chunk scan, rounding to bf16 where the bf16 kernel rounds)
against the Pallas ``ssd_scan`` in interpret mode and against the plain
version ``ssd_scan_ref``, on seeded numpy inputs given to both packages.
The CUDA kernel runs only on the card: chip_smoke.py holds it to the
plain version there. Tolerances: fp32 3e-4, bf16 2e-2, on y and on the
final state."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import ssd_scan as SS
from _torch_parity import jit, one_torch_thread  # noqa: F401

TOL = {"float32": 3e-4, "bfloat16": 2e-2}

CASES = [  # (b, L, H, G, P, N, Q, dtype)
    # tests/test_torch_kernels.py's SSD_CASES
    (2, 256, 4, 1, 64, 32, 64, "float32"),
    (1, 128, 8, 2, 32, 16, 128, "float32"),    # single chunk, G > 1
    (2, 512, 4, 4, 64, 64, 256, "float32"),    # per-head groups
    (1, 256, 2, 1, 64, 128, 128, "float32"),   # mamba2-780m-like state
    (1, 256, 4, 2, 32, 16, 64, "bfloat16"),
    # the same in bf16, where the model rounds as the kernel does
    (2, 256, 4, 1, 64, 32, 64, "bfloat16"),
    (1, 256, 2, 1, 64, 128, 128, "bfloat16"),
    (2, 512, 4, 4, 64, 64, 256, "bfloat16"),
    # one chunk of 96 tokens: a query tile of 64 rows and one of 32
    (1, 96, 2, 1, 32, 16, 128, "float32"),
    (1, 96, 4, 2, 32, 16, 128, "bfloat16"),
    # chip_smoke's phase-3 cases: H 3 with one group, chunks of 64
    (1, 192, 3, 1, 32, 16, 64, "float32"),
    (1, 192, 3, 1, 32, 16, 64, "bfloat16"),
]


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(rng, b, L, H, G, P, N):
    """Shaped like test_kernels.py's: x * 0.5, dt = softplus(randn),
    A = -exp(0.3 randn), B and C * 0.3."""
    x = _rand(rng, b, L, H, P, scale=0.5)
    dt = np.logaddexp(_rand(rng, b, L, H), 0).astype(np.float32)
    A = -np.exp(_rand(rng, H, scale=0.3))
    return x, dt, A, _rand(rng, b, L, G, N, scale=0.3), \
        _rand(rng, b, L, G, N, scale=0.3)


def _np(t):
    return np.asarray(t.float() if torch.is_tensor(t) else t, np.float32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_chunk_model_matches_pallas_and_plain(case):
    b, L, H, G, P, N, Q, dtype = case
    x, dt, A, Bm, Cm = _inputs(np.random.default_rng(L + N + H), b, L, H, G,
                               P, N)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    args = (torch.from_numpy(x).to(td), torch.from_numpy(dt),
            torch.from_numpy(A), torch.from_numpy(Bm).to(td),
            torch.from_numpy(Cm).to(td))
    y, h = SS.ssd_scan_chunked_ref(*args, chunk=Q)
    assert y.dtype == td and h.dtype == td
    assert tuple(y.shape) == x.shape and tuple(h.shape) == (b, H, P, N)
    tol = TOL[dtype]
    wy, wh = jit(pallas_ssd, jnp.asarray(x, jd), jnp.asarray(dt),
                 jnp.asarray(A), jnp.asarray(Bm, jd), jnp.asarray(Cm, jd),
                 chunk=Q, interpret=True)
    py, ph = SS.ssd_scan_ref(*args, chunk=Q)
    for got, pallas, plain in ((y, wy, py), (h, wh, ph)):
        np.testing.assert_allclose(_np(got), _np(pallas), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(got), _np(plain), rtol=tol, atol=tol)


def test_fp32_model_is_the_plain_scan_reordered():
    """Without bf16 rounding the three passes compute the plain version's
    sums in another order: they agree far inside the fp32 tolerance."""
    x, dt, A, Bm, Cm = _inputs(np.random.default_rng(5), 2, 384, 4, 2, 32,
                               32)
    args = [torch.from_numpy(t) for t in (x, dt, A, Bm, Cm)]
    for got, want in zip(SS.ssd_scan_chunked_ref(*args, chunk=128),
                         SS.ssd_scan_ref(*args, chunk=128)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs ssd_scan_ref (not the chunk model,
    no launch), bit for bit."""
    args = [torch.from_numpy(t) for t in
            _inputs(np.random.default_rng(6), 1, 128, 2, 1, 32, 16)]
    launches = SS.ssd_scan.launches
    got = SS.ssd_scan(*args, chunk=64)
    assert SS.ssd_scan.launches == launches
    for g, w in zip(got, SS.ssd_scan_ref(*args, chunk=64)):
        assert torch.equal(g, w)
