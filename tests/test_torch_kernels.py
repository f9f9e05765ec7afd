"""Port parity, kernel API: the plain PyTorch versions of the flash,
decode and SSD kernels (what the wrappers run on CPU tensors) against the
Pallas kernels in interpret mode, on the cases of the reference's own
kernel tests (a subset where interpret mode is slow); flash with
Sq != Sk, a length-0 decode row, the ``ops`` wrappers on padded shapes,
``ops.ssd`` with an initial state, the ``kernels/ref.py`` oracles against
the reference's, and the wrappers' input checks. The CUDA kernels run
only on the card: chip_smoke.py holds them to the plain versions there.
Tolerances: fp32 3e-5 (attention), 4e-4 (SSD, as the reference's own
SSD test), bf16 2e-2."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import ssd_scan as SS
from _torch_parity import jit, one_torch_thread  # noqa: F401

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 4e-4, "bfloat16": 2e-2}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(a, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``
    (bf16 rounding is the same in both: round to nearest even)."""
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ------------------------------------------------------------------ flash
FLASH_CASES = [  # (B, H, KV, Sq, Sk, D, dtype): test_kernels.py:21-25
    (2, 4, 4, 256, 256, 64, "float32"),     # MHA
    (1, 8, 2, 128, 128, 128, "float32"),    # GQA
    (2, 4, 1, 256, 256, 64, "bfloat16"),    # MQA
    (1, 2, 2, 512, 512, 256, "bfloat16"),   # gemma-wide heads
    (1, 4, 2, 128, 256, 64, "float32"),     # Sq < Sk
    (1, 4, 2, 256, 128, 64, "bfloat16"),    # Sq > Sk
    (1, 4, 4, 128, 128, 112, "float32"),    # zamba2-7b's head dim
    (1, 4, 2, 128, 128, 160, "bfloat16"),   # stablelm-12b's
    (1, 2, 2, 128, 128, 80, "float32"),     # a kernel width of its own
    (1, 4, 2, 128, 128, 100, "bfloat16"),   # the padded route on the card
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_plain_matches_pallas(case):
    """The kernel's mask counts q and k positions from 0, so Sq != Sk is
    held against the Pallas kernel, not ref_flash_attention."""
    B, H, KV, Sq, Sk, D, dtype = case
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v = (_pair(_rand(rng, B, n, S, D), dtype)
               for n, S in ((H, Sq), (KV, Sk), (KV, Sk)))
    want = jit(pallas_flash, q[0], k[0], v[0], causal=True, interpret=True)
    got = FA.flash_attention(q[1], k[1], v[1], causal=True)
    assert got.dtype == q[1].dtype and got.shape == q[1].shape
    _close(got, want, TOL[dtype])
    if Sq == Sk:   # where the two masks agree, the oracle too
        _close(got, TR.ref_flash_attention(q[1], k[1], v[1]), TOL[dtype])


def test_flash_non_causal():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_rand(rng, 1, n, 128, 64)) for n in (4, 2, 2))
    want = jit(pallas_flash, *(jnp.asarray(t.numpy()) for t in (q, k, v)),
               causal=False, interpret=True)
    _close(FA.flash_attention(q, k, v, causal=False), want, 3e-5)


# ----------------------------------------------------------------- decode
DECODE_CASES = [  # (B, H, KV, S, D, dtype): test_kernels.py:38-41
    (2, 8, 2, 256, 64, "float32"),
    (3, 4, 4, 128, 128, "bfloat16"),
    (1, 16, 1, 384, 64, "float32"),
    (2, 8, 2, 256, 64, "bfloat16"),
    (2, 4, 2, 128, 100, "bfloat16"),   # rows of 8-byte vectors on the card
    (2, 4, 2, 128, 98, "float32"),     # rows of 8-byte vectors in fp32
]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_decode_plain_matches_pallas(case):
    B, H, KV, S, D, dtype = case
    rng = np.random.default_rng(S + D)
    q = _pair(_rand(rng, B, H, D), dtype)
    k, v = (_pair(_rand(rng, B, KV, S, D), dtype) for _ in range(2))
    lens = (np.arange(1, B + 1) * (S // (B + 1)) + 1).astype(np.int32)
    want = jit(pallas_decode, q[0], k[0], v[0], jnp.asarray(lens),
               interpret=True)
    got = DA.decode_attention(q[1], k[1], v[1], torch.from_numpy(lens))
    assert got.dtype == q[1].dtype and got.shape == q[1].shape
    _close(got, want, TOL[dtype])
    _close(got, TR.ref_decode_attention(q[1], k[1], v[1],
                                        torch.from_numpy(lens)), TOL[dtype])


def test_decode_zero_length_row_is_exactly_zero():
    """As the Pallas kernel gives; the oracles (both packages) give NaN."""
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 3, 8, 64), _rand(rng, 3, 2, 128, 64), \
        _rand(rng, 3, 2, 128, 64)
    lens = np.array([40, 0, 128], np.int32)
    got = DA.decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    assert bool((got[1] == 0).all())
    want = jit(pallas_decode, *map(jnp.asarray, (q, k, v, lens)),
               interpret=True)
    _close(got, want, 3e-5)
    oracle = TR.ref_decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    assert bool(torch.isnan(oracle[1]).all())
    assert np.isnan(np.asarray(JR.ref_decode_attention(
        *map(jnp.asarray, (q, k, v, lens))))[1]).all()


# -------------------------------------------------------------------- SSD
def _ssd_inputs(rng, b, L, H, G, P, N):
    """Shaped like test_kernels.py's: x * 0.5, dt = softplus(randn),
    A = -exp(0.3 randn), B and C * 0.3."""
    x = _rand(rng, b, L, H, P, scale=0.5)
    dt = np.logaddexp(_rand(rng, b, L, H), 0).astype(np.float32)
    A = -np.exp(_rand(rng, H, scale=0.3))
    return x, dt, A, _rand(rng, b, L, G, N, scale=0.3), \
        _rand(rng, b, L, G, N, scale=0.3)


SSD_CASES = [  # (b, L, H, G, P, N, Q, dtype): test_kernels.py:54-58
    (2, 256, 4, 1, 64, 32, 64, "float32"),
    (1, 128, 8, 2, 32, 16, 128, "float32"),    # single chunk, G > 1
    (2, 512, 4, 4, 64, 64, 256, "float32"),    # per-head groups
    (1, 256, 2, 1, 64, 128, 128, "float32"),   # mamba2-780m-like state
    (1, 256, 4, 2, 32, 16, 64, "bfloat16"),
    (1, 128, 2, 1, 128, 32, 64, "float32"),    # two P slabs on the card
    (1, 128, 2, 1, 32, 256, 64, "float32"),    # N 256: the wider pass 3
    (1, 128, 2, 1, 24, 40, 64, "bfloat16"),    # zero-filled to 32 and 48
]


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_plain_matches_pallas(case):
    b, L, H, G, P, N, Q, dtype = case
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(L + N), b, L, H, G,
                                   P, N)
    xj, xt = _pair(x, dtype)
    Bj, Bt = _pair(Bm, dtype)
    Cj, Ct = _pair(Cm, dtype)
    wy, wh = jit(pallas_ssd, xj, jnp.asarray(dt), jnp.asarray(A), Bj, Cj,
                 chunk=Q, interpret=True)
    y, h = SS.ssd_scan(xt, torch.from_numpy(dt), torch.from_numpy(A), Bt, Ct,
                       chunk=Q)
    assert y.dtype == xt.dtype and h.dtype == xt.dtype   # as the Pallas one
    assert tuple(h.shape) == (b, H, P, N)
    _close(y, wy, SSD_TOL[dtype])
    _close(h, wh, SSD_TOL[dtype])


def test_padded_routes_give_the_plain_result():
    """The routes the card takes for rows that are not whole 16-byte
    vectors, with the plain versions standing in for the launches: flash
    on ``pad_head_dim`` copies (D 100 -> 104) with the true head dim's
    scale (the stand-in widens q and rescales it from the padded dim's
    scale to the true one's: 1e-3 holds that to within an fp32 rounding
    of the scores, where the padded dim's scale is 3.5e-2 off), and the
    SSD scan on ``pad_dims`` copies (P 20, N 12 -> 24, 16 in bf16), sliced
    back; both equal the plain versions on the unpadded operands."""
    def launch(q, k, v, causal, scale_dim):
        rescale = math.sqrt(q.shape[-1] / scale_dim)
        return FA.flash_attention_ref(q.float() * rescale, k, v, causal=causal)

    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(_rand(rng, 1, n, 64, 100)).to(torch.bfloat16)
               for n in (4, 2, 2))
    qp, kp, vp = FA.pad_head_dim(q, k, v)
    assert qp.shape[-1] == 104 and bool((qp[..., 100:] == 0).all())
    got = FA.padded_call(launch, q, k, v, True)
    assert got.shape == q.shape and got.stride() == q.stride()
    _close(got, FA.flash_attention_ref(q, k, v), 1e-3)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        _ssd_inputs(rng, 1, 64, 2, 1, 20, 12))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    xp, Bp, Cp = SS.pad_dims(x, Bm, Cm, 8)
    assert xp.shape[-1] == 24 and Bp.shape[-1] == Cp.shape[-1] == 16
    y, h = SS.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=32)
    yp, hp = SS.ssd_scan_ref(xp, dt, A, Bp, Cp, chunk=32)
    _close(yp[..., :20], y, 0.0)
    _close(hp[:, :, :20, :12], h, 0.0)


def test_ref_ssd_matches_reference_oracle():
    """The token-by-token oracles of both packages, with a state."""
    rng = np.random.default_rng(3)
    args = _ssd_inputs(rng, 2, 48, 4, 2, 16, 8)
    h0 = _rand(rng, 2, 4, 16, 8, scale=0.1)
    wy, wh = jit(JR.ref_ssd, *map(jnp.asarray, args),
                 initial_state=jnp.asarray(h0))
    y, h = TR.ref_ssd(*map(torch.from_numpy, args),
                      initial_state=torch.from_numpy(h0))
    _close(y, wy, 1e-5)
    _close(h, wh, 1e-5)


def test_ref_flash_attention_keeps_bottom_right_mask():
    """The oracle aligns its causal mask bottom-right (tril(Sk - Sq)), as
    the reference's does; the kernel does not."""
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 1, 4, 64, 32), _rand(rng, 1, 2, 128, 32), \
        _rand(rng, 1, 2, 128, 32)
    want = JR.ref_flash_attention(*map(jnp.asarray, (q, k, v)))
    got = TR.ref_flash_attention(*map(torch.from_numpy, (q, k, v)))
    _close(got, want, 3e-5)
    kernel = FA.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert not np.allclose(_np(kernel), _np(got), atol=1e-3)


# -------------------------------------------------------------------- ops
def test_ops_wrappers_pad_paths():
    """test_kernels.py:91-108's shapes (S = 200, not a block multiple),
    and the SSD op at L = 200 with chunk 64: the port's ops against the
    reference's ops, which run the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(5)
    B, S, H, KV, D = 2, 200, 4, 2, 64
    q, k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, KV, D), \
        _rand(rng, B, S, KV, D)
    want = JO.flash_attention_bshd(*map(jnp.asarray, (q, k, v)))
    got = TO.flash_attention_bshd(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (B, S, H, D)
    _close(got, want, 3e-5)
    lens = np.array([150, 99], np.int32)
    qd = _rand(rng, B, 1, H, D)
    want = JO.decode_attention_bshd(*map(jnp.asarray, (qd, k, v, lens)))
    got = TO.decode_attention_bshd(*map(torch.from_numpy, (qd, k, v, lens)))
    assert got.shape == (B, 1, H, D)
    _close(got, want, 3e-5)
    args = _ssd_inputs(rng, 2, 200, 4, 2, 32, 16)
    wy, wh = JO.ssd(*map(jnp.asarray, args), chunk=64)
    y, h = TO.ssd(*map(torch.from_numpy, args), chunk=64)
    assert y.shape == (2, 200, 4, 32)
    _close(y, wy, 4e-4)
    _close(h, wh, 4e-4)


def test_ops_flash_padding_quirk_with_sq_ne_sk():
    """Sq = 40 against Sk = 200: the reference pads K to 256 with zero
    rows that the position-0 causal mask lets late queries see; the port
    pads exactly so and gives the same answer."""
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, 1, 40, 2, 64), _rand(rng, 1, 200, 2, 64), \
        _rand(rng, 1, 200, 2, 64)
    want = JO.flash_attention_bshd(*map(jnp.asarray, (q, k, v)))
    got = TO.flash_attention_bshd(*map(torch.from_numpy, (q, k, v)))
    _close(got, want, 3e-5)
    with pytest.raises(ValueError, match="block-aligned"):
        TO.flash_attention_bshd(*map(torch.from_numpy, (q, k, v)),
                                causal=False)


def test_ops_ssd_with_initial_state():
    """A continued scan runs ssd_chunked on both sides (the reference's
    semantics), and the kernel is not launched."""
    rng = np.random.default_rng(7)
    args = _ssd_inputs(rng, 2, 100, 4, 1, 32, 16)
    h0 = _rand(rng, 2, 4, 32, 16, scale=0.1)
    wy, wh = JO.ssd(*map(jnp.asarray, args), chunk=64,
                    initial_state=jnp.asarray(h0))
    y, h = TO.ssd(*map(torch.from_numpy, args), chunk=64,
                  initial_state=torch.from_numpy(h0))
    _close(y, wy, 1e-4)
    _close(h, wh, 1e-4)


# ----------------------------------------------------------- input checks
def test_wrappers_reject_bad_inputs_and_count_only_launches():
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(_rand(rng, 2, n, 32, 64)) for n in (4, 2, 2))
    lens = torch.tensor([3, 0], dtype=torch.int32)
    ssd_args = [torch.from_numpy(a) for a in _ssd_inputs(rng, 1, 64, 4, 2,
                                                         16, 8)]
    counts = (FA.flash_attention.launches, DA.decode_attention.launches,
              SS.ssd_scan.launches)
    FA.flash_attention(q, k, v)             # CPU: the plain versions
    DA.decode_attention(q[:, :, 0].contiguous(), k, v, lens)
    SS.ssd_scan(*ssd_args, chunk=32)
    assert counts == (FA.flash_attention.launches,
                      DA.decode_attention.launches, SS.ssd_scan.launches)

    def bad(fn, args, i, value, exc, **kw):
        a = list(args)
        a[i] = value
        with pytest.raises(exc):
            fn(*a, **kw)

    fa = (q, k, v)
    bad(FA.flash_attention, fa, 0, q.half(), TypeError)        # dtype
    bad(FA.flash_attention, fa, 1, k.to(torch.bfloat16), TypeError)
    bad(FA.flash_attention, fa, 0, q[:, :3], ValueError)       # H % KV
    bad(FA.flash_attention, fa, 2, v[:, :, :16], ValueError)   # k/v shape
    bad(FA.flash_attention, fa, 0, q[0], ValueError)           # rank
    bad(FA.flash_attention, fa, 0, q.transpose(2, 3), ValueError)  # strides
    bad(FA.flash_attention, fa, 1, k[:, :, :0], ValueError)    # no keys
    da = (q[:, :, 0].contiguous(), k, v, lens)
    bad(DA.decode_attention, da, 3, lens.long(), TypeError)
    bad(DA.decode_attention, da, 3, lens[:1], ValueError)
    bad(DA.decode_attention, da, 0, q[:1, :, 0], ValueError)   # batch
    bad(DA.decode_attention, da, 1, k[:, :, :0], ValueError)   # empty cache
    bad(DA.decode_attention, da, 0, da[0].to(torch.bfloat16), TypeError)
    bad(DA.decode_attention, da, 0, q[:, :, 0], ValueError)   # strided q
    bad(SS.ssd_scan, ssd_args, 0, ssd_args[0].half(), TypeError)
    bad(SS.ssd_scan, ssd_args, 3, ssd_args[3][:, :, :1].repeat(1, 1, 3, 1),
        ValueError)                                           # H % G
    bad(SS.ssd_scan, ssd_args, 1, ssd_args[1][:, :32], ValueError)
    bad(SS.ssd_scan, ssd_args, 0, ssd_args[0].transpose(2, 3).contiguous()
        .transpose(2, 3), ValueError)                         # contiguity
    with pytest.raises(ValueError, match="multiple of the chunk"):
        SS.ssd_scan(*ssd_args, chunk=48)


def test_gelu_wrappers_run_plain_on_cpu():
    """The gelu kernel's wrappers on CPU tensors are its plain versions
    (the chain and JAX's VJP of it), count no launch, and refuse other
    types and a mismatched cotangent; ``layers._gelu`` takes its gradient
    through ``gelu_grad``."""
    from repro_torch.kernels import gelu as GK
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(9)
    x, g = (torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32)
                             * 3).to(torch.bfloat16) for _ in range(2))
    counts = (GK.gelu.launches, GK.gelu_grad.launches)
    assert torch.equal(GK.gelu(x), GK.gelu_ref(x))
    assert torch.equal(GK.gelu_grad(x, g), GK.gelu_grad_ref(x, g))
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(TL._gelu(xg), xg, g)
    assert torch.equal(dx, GK.gelu_grad_ref(x, g))
    assert counts == (GK.gelu.launches, GK.gelu_grad.launches)
    with pytest.raises(TypeError):
        GK.gelu(x.int())
    with pytest.raises(ValueError):
        GK.gelu_grad(x, g[:2])
    with pytest.raises(ValueError):
        GK.gelu_grad(x, g.float())
