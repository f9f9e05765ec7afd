"""Port parity, paged-decode kernel module: the plain PyTorch version
(what the wrapper runs on CPU tensors) against the Pallas kernel in
interpret mode and the reference's paged_attention_ref, on the cases of
the reference's own kernel tests; and the wrapper's input checks.
The CUDA kernel itself runs only on the card: chip_smoke.py holds it to
the plain version there. Tolerances: fp32 3e-5, bf16 2e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_decode_attention as pallas_paged
from repro.serving import paged_kv as JPK
from repro_torch.kernels import paged_decode as PD
from _torch_parity import one_torch_thread  # noqa: F401


def _case(lens, *, H, KV, hd=64, bs=8, n_blocks=16, seed=7):
    """A pool with ``lens`` tokens per row (blocks handed out like the
    reference's allocator), a query, and the table with -1 past each
    row's blocks."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((2, n_blocks, KV, bs, hd)).astype(np.float32)
    width = -(-max(lens) // bs) + 1
    tables = np.full((len(lens), width), -1, np.int32)
    free = list(range(n_blocks))
    for b, n in enumerate(lens):
        for c in range(-(-n // bs)):
            tables[b, c] = free.pop()
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


def _jax_ref(q, pool, tables, lens, dtype):
    """The reference's paged_attention_ref over an equivalent PagedState."""
    jd = getattr(jnp, dtype)
    st = JPK.PagedState(
        k=jnp.asarray(pool[0][None], jd), v=jnp.asarray(pool[1][None], jd),
        block_tables=tables.copy(), lengths=lens.copy(),
        free=[], block_size=pool.shape[3])
    return np.asarray(JPK.paged_attention_ref(
        jnp.asarray(q, jd), st, list(range(len(lens))), layer=0), np.float32)


CASES = {  # name: (lens, H, KV, head dim, dtype, tol)
    "reduced": ([20, 7, 33], 4, 4, 64, "float32", 3e-5),
    "gqa_fp32": ([20, 7, 33], 8, 2, 64, "float32", 3e-5),
    "gqa_bf16": ([20, 7, 33], 8, 2, 64, "bfloat16", 2e-2),
    "block_boundaries": ([8, 16, 1, 17], 4, 4, 64, "float32", 3e-5),
    # a bf16 row of 200 bytes: the kernel reads it in 8-byte vectors
    "head_dim_100": ([20, 7, 33], 8, 2, 100, "bfloat16", 2e-2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_and_reference(name):
    lens, H, KV, hd, dtype, tol = CASES[name]
    q, pool, tables, ln = _case(lens, H=H, KV=KV, hd=hd)
    got = PD.paged_decode_attention(*_torch(q, pool, tables, ln, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, _pallas(q, pool, tables, ln, dtype),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _jax_ref(q, pool, tables, ln, dtype),
                               rtol=tol, atol=tol)


def test_zero_length_row_and_negative_entries():
    """A length-0 row gives exact zeros (as the Pallas kernel does); a -1
    entry below a row's length reads block 0, in both."""
    q, pool, tables, ln = _case([8, 16, 1, 17], H=4, KV=4)
    ln[1] = 0
    tables[3, 1] = -1
    got = PD.paged_decode_attention(*_torch(q, pool, tables, ln, "float32"))
    assert (got[1] == 0).all()
    np.testing.assert_allclose(
        got.numpy(), _pallas(q, pool, tables, ln, "float32"),
        rtol=3e-5, atol=3e-5)


def test_wrapper_rejects_bad_inputs_and_counts_only_launches():
    q, pool, tables, ln = _case([9, 4], H=8, KV=2)
    args = list(_torch(q, pool, tables, ln, "float32"))
    before = PD.paged_decode_attention.launches
    PD.paged_decode_attention(*args)        # CPU: the plain version
    assert PD.paged_decode_attention.launches == before

    def bad(i, value, exc):
        a = list(args)
        a[i] = value
        with pytest.raises(exc):
            PD.paged_decode_attention(*a)

    bad(0, args[0].half(), TypeError)                  # unsupported dtype
    bad(1, args[1].to(torch.bfloat16), TypeError)      # mixed dtypes
    bad(3, args[3].long(), TypeError)                  # table not int32
    bad(4, args[4].long(), TypeError)                  # lengths not int32
    bad(0, args[0][:, :7].contiguous(), ValueError)    # H not multiple of KV
    bad(2, args[2][:, :, :4].contiguous(), ValueError)  # k/v mismatch
    bad(3, args[3][:1], ValueError)                    # table rows != B
    bad(4, args[4][:1], ValueError)                    # lengths != B
    bad(0, args[0].transpose(0, 1).contiguous().transpose(0, 1),
        ValueError)                                    # non-contiguous q
    bad(1, args[1].transpose(2, 3).contiguous().transpose(2, 3),
        ValueError)                                    # non-contiguous pool
