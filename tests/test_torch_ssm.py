"""Port parity, Mamba2 mixer (models/ssm.py) at mamba2-780m.reduced():
segsum, ssd_chunked (ragged L, with and without a state),
ssd_decode_step, apply_mamba2 (with ``ssd_fn`` = each package's
``kernels.ops.ssd``, and with the default ``ssd_chunked``, from zero and
from a carried state) and apply_mamba2_decode, on the reference's
``init_mamba2`` weights bridged through numpy. Tolerances: fp32 1e-4,
bf16 2e-2; softplus 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as JO
from repro.models import ssm as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ssd_scan as SS
from repro_torch.models import ssm as TS
from _torch_parity import jit, one_torch_thread  # noqa: F401

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ARCH = "mamba2-780m"


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mixer(dtype):
    """Both configs, the reference's weights in ``dtype`` and the same
    weights bridged to torch."""
    jc, tc = jax_config(ARCH).reduced(), torch_config(ARCH).reduced()
    jp = JS.init_mamba2(jc, jax.random.PRNGKey(0), getattr(jnp, dtype))
    return jc, tc, jp, params_from_numpy(_tree_np(jp), "cpu")


def _ssd_inputs(rng, b, L, H, G, P, N):
    x = rng.standard_normal((b, L, H, P)).astype(np.float32) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, L, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, L, G, N)).astype(np.float32) * 0.3
    C = rng.standard_normal((b, L, G, N)).astype(np.float32) * 0.3
    return x, dt, A, B, C


def test_segsum_and_softplus():
    rng = np.random.default_rng(0)
    dA = -np.abs(rng.standard_normal((2, 3, 16))).astype(np.float32)
    _close(TS.segsum(torch.from_numpy(dA)).nan_to_num(neginf=-1e30),
           np.nan_to_num(np.asarray(JS.segsum(jnp.asarray(dA))),
                         neginf=-1e30), 1e-6)
    # softplus has no linear switch at 20 in either package
    x = np.linspace(-30, 40, 141, dtype=np.float32)
    _close(TS._softplus(torch.from_numpy(x)),
           jax.nn.softplus(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_and_decode_step(dtype):
    """The reduced config's widths (H 16, P 32, N 16, chunk 64) over a
    ragged L = 150, from zero and from a state; then one decode step."""
    cfg = torch_config(ARCH).reduced()
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_ngroups
    rng = np.random.default_rng(1)
    x, dt, A, B, C = _ssd_inputs(rng, 2, 150, H, G, P, N)
    h0 = (rng.standard_normal((2, H, P, N)) * 0.1).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jargs(*a):
        return [jnp.asarray(a[0], jd), jnp.asarray(a[1]), jnp.asarray(a[2]),
                jnp.asarray(a[3], jd), jnp.asarray(a[4], jd)]

    def targs(*a):
        return [torch.from_numpy(a[0]).to(td), torch.from_numpy(a[1]),
                torch.from_numpy(a[2]), torch.from_numpy(a[3]).to(td),
                torch.from_numpy(a[4]).to(td)]

    for state in (None, h0):
        wy, wh = jit(JS.ssd_chunked, *jargs(x, dt, A, B, C), cfg.ssm_chunk,
                     None if state is None else jnp.asarray(state, jd))
        y, h = TS.ssd_chunked(*targs(x, dt, A, B, C), cfg.ssm_chunk,
                              None if state is None
                              else torch.from_numpy(state).to(td))
        assert y.dtype == td and h.dtype == td and y.shape == x.shape
        _close(y, wy, TOL[dtype])
        _close(h, wh, TOL[dtype])
    step = [a[:, 0] for a in (x, dt)] + [A] + [a[:, 0] for a in (B, C)]
    wy, wh = jit(JS.ssd_decode_step, *jargs(*step), jnp.asarray(h0))
    y, h = TS.ssd_decode_step(*targs(*step), torch.from_numpy(h0))
    _close(y, wy, TOL[dtype])
    _close(h, wh, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba2_through_the_kernel_api(dtype):
    """A prefill of 100 tokens with ``ssd_fn`` = ops.ssd on both sides
    (the port's runs the SSD kernel's plain version: one launch-counted
    path, zero launches on the CPU), then a continuation of 37 tokens from
    the carried state (ops.ssd -> ssd_chunked on both sides), then two
    decode steps."""
    jc, tc, jp, tp = _mixer(dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 139, jc.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xt = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    launches = SS.ssd_scan.launches

    wo, wst = jit(JS.apply_mamba2, jp, xj[:, :100], jc, ssd_fn=JO.ssd)
    to, tst = TS.apply_mamba2(tp, xt[:, :100], tc, ssd_fn=TO.ssd)
    assert to.dtype == td and to.shape == (2, 100, jc.d_model)
    _close(to, wo, TOL[dtype])
    for key in ("conv_x", "conv_B", "conv_C", "ssd"):
        _close(tst[key], wst[key], TOL[dtype])

    wo2, wst2 = jit(JS.apply_mamba2, jp, xj[:, 100:137], jc, state=wst,
                    ssd_fn=JO.ssd)
    to2, tst2 = TS.apply_mamba2(tp, xt[:, 100:137], tc, state=tst,
                                ssd_fn=TO.ssd)
    _close(to2, wo2, TOL[dtype])
    _close(tst2["ssd"], wst2["ssd"], TOL[dtype])

    wst3, tst3 = wst2, tst2
    for t in (137, 138):
        wo3, wst3 = jit(JS.apply_mamba2_decode, jp, xj[:, t:t + 1], jc,
                        state=wst3)
        to3, tst3 = TS.apply_mamba2_decode(tp, xt[:, t:t + 1], tc,
                                           state=tst3)
        assert to3.shape == (2, 1, jc.d_model)
        _close(to3, wo3, TOL[dtype])
        for key in ("conv_x", "conv_B", "conv_C", "ssd"):
            _close(tst3[key], wst3[key], TOL[dtype])
    assert SS.ssd_scan.launches == launches


def test_apply_mamba2_default_scan_is_ssd_chunked():
    """Without ``ssd_fn`` both packages run ssd_chunked; with the
    kernel API the port's result agrees with it (fp32)."""
    jc, tc, jp, tp = _mixer("float32")
    x = np.random.default_rng(3).standard_normal(
        (1, 90, jc.d_model)).astype(np.float32)
    wo, _ = jit(JS.apply_mamba2, jp, jnp.asarray(x), jc)
    to, _ = TS.apply_mamba2(tp, torch.from_numpy(x), tc)
    _close(to, wo, 1e-4)
    tk, _ = TS.apply_mamba2(tp, torch.from_numpy(x), tc, ssd_fn=TO.ssd)
    _close(tk, to.numpy(), 1e-4)


def test_init_mamba2_matches_reference_shapes():
    """Same keys, shapes and types as the reference's init (the values
    come from another generator); the formulas' fixed parts agree."""
    jc, tc, jp, _ = _mixer("bfloat16")
    gen = torch.Generator().manual_seed(0)
    tp = TS.init_mamba2(tc, gen, torch.bfloat16)
    assert set(tp) == set(jp)
    for key, ref in jp.items():
        assert tuple(tp[key].shape) == ref.shape, key
        assert str(tp[key].dtype).split(".")[-1] == ref.dtype.name, key
    for key in ("A_log", "D", "norm_scale", "conv_x_b"):
        np.testing.assert_allclose(np.asarray(tp[key].float()),
                                   np.asarray(jp[key], np.float32),
                                   rtol=1e-6)
    assert torch.equal(tp["conv_B_w"], tp["conv_C_w"])   # one key, as there
    dt0 = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt0 > 0.00099) & (dt0 < 0.1001)).all())
