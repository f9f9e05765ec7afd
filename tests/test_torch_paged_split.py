"""Port parity, split-K paged decode: the plain PyTorch model of the paged
kernel's split algorithm (``paged_decode_attention_split_ref``: the ranges
of ``plan_paged_splits`` over the block table, per-split fp32 partials,
then the combine) against the Pallas ``paged_decode_attention`` in
interpret mode and against the plain version
``paged_decode_attention_ref``; and the planner itself. The CUDA kernel
runs only on the card: chip_smoke.py holds it to the plain version there.
Tolerances: fp32 3e-5, bf16 2e-2; length-0 rows exactly zero."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_decode_attention as pallas_paged
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import paged_decode as PD
from _torch_parity import one_torch_thread  # noqa: F401

TOL = {"float32": 3e-5, "bfloat16": 2e-2}

# (lengths, H, KV, bs, dtype, n_sm, extra table columns, hole); a hole is a
# -1 entry below a row's length (it reads block 0, in both kernels). The
# comment gives (n_split, span) of plan_paged_splits.
CASES = [
    # the cases of test_torch_paged_decode.py, bs 8: (1, 64)
    ([20, 7, 33], 4, 4, 8, "float32", 132, 1, False),
    ([20, 7, 33], 8, 2, 8, "float32", 132, 1, False),
    ([20, 7, 33], 8, 2, 8, "bfloat16", 132, 1, False),
    ([8, 16, 1, 17], 4, 4, 8, "float32", 132, 1, False),
    # bs 16, (3, 64): lengths on the split boundaries 64 and 128 and
    # beside them, a length-0 row, -1 entries past every row's blocks
    ([64, 128, 0, 65, 63], 8, 2, 16, "float32", 132, 2, False),
    # bs 16, (3, 64), bf16: a -1 hole below a length, a 0 row
    ([129, 0, 40], 8, 2, 16, "bfloat16", 132, 1, True),
    # bs 8, (4, 64): a length ending on a block boundary inside a split
    ([96, 200, 8], 4, 1, 8, "float32", 132, 3, True),
    # a tiny card: one split of the whole table (1, 256), then (2, 128)
    ([200, 3], 8, 2, 8, "float32", 2, 8, False),
    ([150, 40, 96], 4, 2, 8, "bfloat16", 1, 4, False),
    # every row empty
    ([0, 0], 4, 4, 16, "bfloat16", 132, 2, False),
    # a block size above 64: spans of whole 128-token blocks, (2, 128)
    ([130, 5], 4, 2, 128, "float32", 132, 0, False),
    # bs 48: spans a multiple of lcm(64, 48) = 192, (2, 192)
    ([191, 193, 0], 4, 2, 48, "float32", 132, 1, False),
]


def _case(lens, H, KV, bs, extra, hole, hd=64, seed=11):
    """A pool with ``lens`` tokens per row (distinct blocks, handed out in
    a shuffled order), a query, and the table with -1 past each row's
    blocks and ``extra`` more columns."""
    rng = np.random.default_rng(seed + sum(lens) + bs)
    cols = [-(-n // bs) for n in lens]
    n_blocks = sum(cols) + 2
    pool = rng.standard_normal((2, n_blocks, KV, bs, hd)).astype(np.float32)
    width = max(max(cols), 1) + extra
    tables = np.full((len(lens), width), -1, np.int32)
    ids = iter(rng.permutation(n_blocks))
    for b, c in enumerate(cols):
        for j in range(c):
            tables[b, j] = next(ids)
    if hole:
        b = max(range(len(lens)), key=lambda i: lens[i])
        tables[b, cols[b] // 2] = -1
    q = rng.standard_normal((len(lens), H, hd)).astype(np.float32)
    return q, pool, tables, np.asarray(lens, np.int32)


def _torch(q, pool, tables, lens, dtype):
    td = getattr(torch, dtype)
    return (torch.from_numpy(q).to(td), torch.from_numpy(pool[0]).to(td),
            torch.from_numpy(pool[1]).to(td), torch.from_numpy(tables),
            torch.from_numpy(lens))


def _pallas(q, pool, tables, lens, dtype):
    jd = getattr(jnp, dtype)
    return np.asarray(jax.jit(lambda: pallas_paged(
        jnp.asarray(q, jd), jnp.asarray(pool[0], jd),
        jnp.asarray(pool[1], jd), jnp.asarray(tables), jnp.asarray(lens),
        interpret=True))(), np.float32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) if not isinstance(x, list) else "_".join(map(str, x)) for x in c))
def test_split_model_matches_pallas_and_plain(case):
    lens, H, KV, bs, dtype, n_sm, extra, hole = case
    q, pool, tables, ln = _case(lens, H, KV, bs, extra, hole)
    args = _torch(q, pool, tables, ln, dtype)
    got = PD.paged_decode_attention_split_ref(*args, n_sm=n_sm)
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    tol = TOL[dtype]
    got32 = got.float().numpy()
    np.testing.assert_allclose(got32, _pallas(q, pool, tables, ln, dtype),
                               rtol=tol, atol=tol)
    plain = PD.paged_decode_attention_ref(*args).float().numpy()
    np.testing.assert_allclose(got32, plain, rtol=tol, atol=tol)
    for b, n in enumerate(lens):
        if n == 0:
            assert bool((got[b] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens,n_sm", [([130, 0, 17, 64], 132),
                                       ([300, 48, 1], 2)])
def test_split_model_mha_head_dim_128(lens, n_sm, dtype):
    """qwen2-moe's decode shape: MHA (H = KV = 16, one query head per KV
    head) at head_dim 128, bs 16, a length-0 row; on a tiny card the
    splits span several 64-position chunks."""
    q, pool, tables, ln = _case(lens, 16, 16, 16, 1, False, hd=128)
    args = _torch(q, pool, tables, ln, dtype)
    got = PD.paged_decode_attention_split_ref(*args, n_sm=n_sm).float()
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), _pallas(q, pool, tables, ln, dtype),
                               rtol=tol, atol=tol)
    plain = PD.paged_decode_attention_ref(*args).float().numpy()
    np.testing.assert_allclose(got.numpy(), plain, rtol=tol, atol=tol)
    for b, n in enumerate(lens):
        if n == 0:
            assert bool((got[b] == 0).all())


@pytest.mark.parametrize("bs", [8, 16, 48, 128])
@pytest.mark.parametrize("shape", [
    (8, 4, 64),        # chip_smoke's decode step: 16 splits of 64 at bs 16
    (8, 4, 1),         # one table column early in a run
    (8, 4, 2),
    (1, 1, 700),       # one long row
    (64, 8, 16),       # B * KV alone almost covers the card
])
@pytest.mark.parametrize("n_sm", [132, 3])
def test_plan_spans_are_whole_blocks(shape, bs, n_sm):
    """A split is a whole number of pool blocks and of 64-position chunks,
    and the splits cover the table's capacity."""
    B, KV, mb = shape
    n_split, span = PD.plan_paged_splits(B, KV, mb, bs, n_sm)
    S = mb * bs
    assert span % bs == 0 and span % DA.SPLIT_CHUNK == 0
    assert 1 <= n_split <= math.ceil(S / math.lcm(DA.SPLIT_CHUNK, bs))
    assert n_split * span >= S
    assert (n_split - 1) * span < S            # no split wholly past S
    assert span == DA.plan_splits(
        B, KV, S, n_sm, math.lcm(DA.SPLIT_CHUNK, bs))[1]


def test_plan_values():
    """The grids chip_smoke checks and times (132 SMs)."""
    assert PD.plan_paged_splits(8, 4, 64, 16) == (16, 64)
    assert PD.plan_paged_splits(8, 4, 1, 16) == (1, 64)
    assert PD.plan_paged_splits(8, 4, 4, 128) == (4, 128)
    assert PD.plan_paged_splits(8, 4, 64, 32) == (16, 128)   # not 17
    # qwen2-moe's decode step (KV 16): 4 splits of 256
    assert PD.plan_paged_splits(8, 16, 64, 16) == (4, 256)
    # the engine's pow2 width bucket changes the grid, from shapes alone
    assert [PD.plan_paged_splits(8, 4, w, 16)[0] for w in (8, 16, 32)] \
        == [2, 4, 8]


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs paged_decode_attention_ref (no
    split, no launch), bit for bit."""
    q, pool, tables, ln = _case([30, 0, 17], 8, 2, 8, 2, True)
    args = _torch(q, pool, tables, ln, "float32")
    launches = PD.paged_decode_attention.launches
    got = PD.paged_decode_attention(*args)
    assert PD.paged_decode_attention.launches == launches
    assert torch.equal(got, PD.paged_decode_attention_ref(*args))
