"""Paged decode attention: one new token per row against a block-table KV
pool, GQA-grouped, fp32 online softmax.

``paged_decode_attention`` is the wrapper the model calls. On CUDA
tensors it launches the hand-written Hopper kernel
(``csrc/paged_decode.cu``, the port of the Pallas kernel
``repro/kernels/paged_decode.py``) on the current stream; on CPU tensors
it runs ``paged_decode_attention_ref``, the plain PyTorch version beside
it. There is no fallback: a kernel that fails to build or launch raises.
``paged_decode_attention.launches`` counts calls that launched the kernel
(plain-version calls do not count); each such call is two launches on
the card, the split-K pass and the combine. Inside a CUDA-graph capture
a call records its launches instead of running them, and a replay runs
them without calling the wrapper: ``serving.graphs.launches_run``
accounts a replay as the launches its capture recorded.

The kernel cuts the table's capacity ``max_blocks * bs`` into ranges of
whole pool blocks (``plan_paged_splits``: dense decode's ``plan_splits``
with spans a multiple of 64 and of the block size, a pure function of
the shapes and the SM count) and merges their partial softmax states in
a second pass. ``paged_decode_attention_split_ref`` is that algorithm in
plain PyTorch, for the tests.

Any head dim runs on the kernel: it reads pool rows in the widest
vectors (16, 8, 4 or 2 bytes) that divide the row, chosen at launch, so
the pool, which the engine updates in place, is never copied or padded.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (H100_SMS, SPLIT_CHUNK,
                                                  plan_splits, sm_count,
                                                  split_attention)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k_pool, v_pool, block_tables, lengths):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be [B,H,D] and pools [n_blocks,KV,bs,D]; "
                         f"got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, H, D = q.shape
    n_blocks, KV, bs, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D or H % KV != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] == 0 or tuple(lengths.shape) != (B,):
        raise ValueError(f"block_tables must be [B, max_blocks>0] and "
                         f"lengths [B] for B={B}; got "
                         f"{tuple(block_tables.shape)}, {tuple(lengths.shape)}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and pools must share float32 or bfloat16; got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")


def _gather(pool, block_tables):
    """[n_blocks, KV, bs, D] pool -> [B, KV, max_blocks * bs, D] fp32,
    entries outside [0, n_blocks) reading block 0."""
    n_blocks, KV, bs, D = pool.shape
    B, mb = block_tables.shape
    tbl = block_tables.long()
    tbl = torch.where((tbl >= 0) & (tbl < n_blocks), tbl, 0)
    return pool[tbl].float().permute(0, 2, 1, 3, 4).reshape(B, KV, mb * bs,
                                                            D)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths):
    """Plain PyTorch version: gather the table's blocks, masked fp32
    softmax (mirrors ``serving/paged_kv.paged_attention_ref``), with the
    kernel's guards so a length-0 row gives exact zeros."""
    B, H, D = q.shape
    n_blocks, KV, bs, _ = k_pool.shape
    R = H // KV
    mb = block_tables.shape[1]
    k = _gather(k_pool, block_tables)
    v = _gather(v_pool, block_tables)
    qg = q.float().reshape(B, KV, R, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bkrd,bksd->bkrs", qg, k)
    valid = (torch.arange(mb * bs, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    safe = torch.where(torch.isinf(m), 0.0, m)
    p = torch.where(valid, torch.exp(s - safe), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkrs,bksd->bkrd", p, v) \
        / torch.where(denom == 0.0, 1.0, denom)
    return out.reshape(B, H, D).to(q.dtype)


def plan_paged_splits(B: int, KV: int, max_blocks: int, bs: int,
                      n_sm: int = H100_SMS):
    """(n_split, span) over a [B, max_blocks] table of ``bs``-token blocks:
    ``plan_splits`` over its capacity ``max_blocks * bs`` with spans a
    multiple of lcm(64, bs), so that a split is a whole number of pool
    blocks, and no split wholly past the table. Shapes only, never the
    lengths."""
    S = max_blocks * bs
    _, span = plan_splits(B, KV, S, n_sm, math.lcm(SPLIT_CHUNK, bs))
    return -(-S // span), span


def paged_decode_attention_split_ref(q, k_pool, v_pool, block_tables,
                                     lengths, n_sm: int = H100_SMS):
    """The kernel's algorithm in plain PyTorch (tests only): the splits of
    ``plan_paged_splits`` over the table, each one's partial, then the
    combine (``decode_attention.split_attention``)."""
    n_blocks, KV, bs, _ = k_pool.shape
    B, mb = block_tables.shape
    n_split, span = plan_paged_splits(B, KV, mb, bs, n_sm)
    k = _gather(k_pool, block_tables)
    v = _gather(v_pool, block_tables)
    return split_attention(q, k, v, lengths, n_split, span)


@functools.cache
def _kernel():
    fn = build.load("paged_decode").paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """q: [B, H, D] (H a multiple of KV); k/v_pool: [n_blocks, KV, bs, D]
    (the serving pool's KV-head-major layout); block_tables:
    [B, max_blocks] int32 (entries outside [0, n_blocks) read block 0 and
    are masked by length); lengths: [B] int32 (0 = inactive, output is
    zeros). All contiguous, on one device. Returns [B, H, D] in q.dtype.

    On CUDA this is two launches (the split-K pass over
    ``plan_paged_splits``'s grid, then the combine) into a workspace
    allocated here; no host sync, so the call can be captured in a CUDA
    graph."""
    _check(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    build.check_no_grad("paged_decode_attention", q, k_pool, v_pool)
    B, H, D = q.shape
    n_blocks, KV, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    mb = block_tables.shape[1]
    n_split, span = plan_paged_splits(B, KV, mb, bs,
                                      sm_count(q.device.index))
    # partials: acc [B*H, n_split, D], then m and l [B*H, n_split], fp32
    ws = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), _DTYPE_CODES[q.dtype], B, H, KV, D, bs, mb,
            n_blocks, n_split, span, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: "
                           f"cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
