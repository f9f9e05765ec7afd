"""Port parity, split-K decode: the plain PyTorch model of the dense decode
kernel's split algorithm (``decode_attention_split_ref``: the ranges of
``plan_splits``, per-split fp32 partials, then the combine) against the
Pallas ``decode_attention`` in interpret mode and against the plain
version ``decode_attention_ref``; and the planner itself. The CUDA kernel
runs only on the card: chip_smoke.py holds it to the plain version there.
Tolerances: fp32 3e-5, bf16 2e-2; length-0 rows exactly zero."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import decode_attention as DA
from _torch_parity import jit, one_torch_thread  # noqa: F401

TOL = {"float32": 3e-5, "bfloat16": 2e-2}

# (B, H, KV, S, D, dtype, lengths, n_sm); S is a multiple of the Pallas
# kernel's block (min(128, S)). The comment gives (n_split, span).
CASES = [
    # (8, 64): a length-0 row, one past S, one on a split boundary
    (3, 8, 2, 512, 64, "float32", [0, 600, 128], 132),
    # MHA, (4, 64): on a boundary and inside the last split
    (2, 4, 4, 256, 128, "bfloat16", [64, 193], 132),
    # D 256, (6, 64): a length of 1 leaves five splits wholly past it
    (2, 4, 1, 384, 256, "float32", [1, 256], 132),
    # one row, (16, 64): many splits, the row ends mid-way
    (1, 16, 2, 1024, 64, "bfloat16", [700], 132),
    # MHA, every row empty
    (2, 8, 8, 128, 64, "bfloat16", [0, 0], 132),
    # lengths around a boundary, D 128
    (4, 8, 2, 256, 128, "float32", [255, 256, 257, 64], 132),
    # a small card, (4, 128): splits wider than the kernel's chunk
    (1, 8, 2, 512, 64, "float32", [300], 2),
    # GQA R 8, (4, 192): a span that is not a power of two
    (2, 32, 4, 768, 64, "bfloat16", [767, 192], 8),
]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) if not isinstance(x, list) else "_".join(map(str, x)) for x in c))
def test_split_model_matches_pallas_and_plain(case):
    B, H, KV, S, D, dtype, lengths, n_sm = case
    rng = np.random.default_rng(S + D + B)
    q = _pair(_rand(rng, B, H, D), dtype)
    k, v = (_pair(_rand(rng, B, KV, S, D), dtype) for _ in range(2))
    lens = np.array(lengths, np.int32)
    got = DA.decode_attention_split_ref(q[1], k[1], v[1],
                                        torch.from_numpy(lens), n_sm=n_sm)
    assert got.dtype == q[1].dtype and got.shape == q[1].shape
    want = jit(pallas_decode, q[0], k[0], v[0], jnp.asarray(lens),
               interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    plain = DA.decode_attention_ref(q[1], k[1], v[1], torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), _np(plain), rtol=tol, atol=tol)
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())


@pytest.mark.parametrize("shape", [
    (8, 4, 1024),      # tinyllama decode in chip_smoke: 16 splits of 64
    (1, 4, 32768),     # one long row: 132 splits of 256
    (1, 1, 10),        # shorter than one span
    (64, 8, 4096),     # B * KV almost covers the card four times
    (128, 8, 4096),    # B * KV alone covers it: no split
    (3, 2, 200),       # capped at ceil(S / 64)
    (2, 16, 100000),
])
@pytest.mark.parametrize("n_sm", [132, 16])
def test_plan_splits_covers_the_card(shape, n_sm):
    B, KV, S = shape
    n_split, span = DA.plan_splits(B, KV, S, n_sm)
    cap = math.ceil(S / DA.SPLIT_CHUNK)
    assert 1 <= n_split <= cap
    want = DA.BLOCKS_PER_SM * n_sm
    assert B * KV * n_split >= min(want, B * KV * cap)
    assert n_split == 1 or B * KV * (n_split - 1) < want   # no more than that
    assert span % DA.SPLIT_CHUNK == 0
    assert n_split * span >= S                       # every position covered
    assert span < math.ceil(S / n_split) + DA.SPLIT_CHUNK


def test_plan_splits_values():
    """The grids chip_smoke times and checks (132 SMs)."""
    assert DA.plan_splits(8, 4, 1024) == (16, 64)
    assert DA.plan_splits(1, 4, 32768) == (132, 256)
    assert DA.plan_splits(64, 8, 4096) == (2, 2048)
    assert DA.plan_splits(128, 8, 4096) == (1, 4096)
    assert DA.plan_splits(3, 2, 200) == (4, 64)


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs decode_attention_ref (no split, no
    launch), bit for bit."""
    rng = np.random.default_rng(9)
    q, k, v = _rand(rng, 2, 8, 64), _rand(rng, 2, 2, 256, 64), \
        _rand(rng, 2, 2, 256, 64)
    lens = torch.tensor([0, 200], dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (q, k, v)] + [lens]
    launches = DA.decode_attention.launches
    got = DA.decode_attention(*args)
    assert DA.decode_attention.launches == launches
    assert torch.equal(got, DA.decode_attention_ref(*args))
