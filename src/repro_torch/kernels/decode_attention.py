"""Decode attention: one query token per row against a dense KV cache,
GQA-grouped, fp32 online softmax, masked by per-row length.

``decode_attention`` is the wrapper. On CUDA tensors it launches the
hand-written Hopper kernel (``csrc/decode_attention.cu``, the port of the
Pallas kernel ``repro/kernels/decode_attention.py``) on the current
stream; on CPU tensors it runs ``decode_attention_ref``, the plain
PyTorch version beside it. There is no fallback: a kernel that fails to
build or launch raises. ``decode_attention.launches`` counts calls that
launched the kernel (plain-version calls do not count); each such call is
two launches on the card, the split-K pass and the combine.

The kernel cuts the sequence into ``n_split`` ranges (``plan_splits``, a
pure function of the shapes and the SM count) and merges their partial
softmax states in a second pass. ``decode_attention_split_ref`` is that
algorithm in plain PyTorch, for the tests.

Any head dim and any strides with a contiguous last dim run on the
kernel: it reads cache rows in the widest vectors (16, 8, 4 or 2 bytes)
that divide the row, the strides and the base addresses, chosen at launch
(``common.cuh``: row_vec_bytes).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_CHUNK = 64       # a split's span is a multiple of this many positions
BLOCKS_PER_SM = 4      # split-K grid: at least this many blocks per SM
H100_SMS = 132


def plan_splits(B: int, KV: int, S: int, n_sm: int = H100_SMS,
                multiple: int = SPLIT_CHUNK):
    """(n_split, span) for a [B, KV, S] cache: enough splits that the
    B * KV * n_split thread blocks cover ``n_sm`` SMs four times, at most
    ceil(S / multiple); each split takes ``span`` positions,
    ceil(S / n_split) rounded up to a multiple of ``multiple`` (64, or for
    a paged pool a multiple of its block size too), so the last splits may
    start past S (they, and every split past a row's length, are empty).
    Shapes only: reading ``lengths`` would be a device-to-host sync.

    Four blocks per SM rather than two: at decode lengths a block's
    serial walk over its span, not the SM count, sets the time; at B 8,
    S 1024 on an H100, chip_smoke.py timed 0.0177 ms with 9 splits of
    128 and 0.0146 ms with 16 of 64 (PERF.md)."""
    cap = -(-S // multiple)
    n_split = max(1, min(cap, -(-BLOCKS_PER_SM * n_sm // (B * KV))))
    per_split = -(-S // n_split)
    span = multiple * -(-per_split // multiple)
    return n_split, span


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(q, k, v, lengths):
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be [B,H,D] and k/v [B,KV,S,D]; got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, D = q.shape
    Bk, KV, S, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or H % KV != 0 or S == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B] for B={B}; got "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("all operands must lie on one device")
    if not (q.is_contiguous() and lengths.is_contiguous()
            and k.stride(-1) == 1 and v.stride(-1) == 1):
        raise ValueError("q and lengths must be contiguous, and k/v "
                         "contiguous in their last dim")


def decode_attention_ref(q, k, v, lengths):
    """Plain PyTorch version: masked fp32 softmax over the cache, with the
    kernel's guards, so a length-0 row gives exact zeros."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bkrd,bksd->bkrs", qg, k.float())
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    safe = torch.where(torch.isinf(m), 0.0, m)
    p = torch.where(valid, torch.exp(s - safe), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkrs,bksd->bkrd", p, v.float()) \
        / torch.where(denom == 0.0, 1.0, denom)
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_split_ref(q, k, v, lengths, n_sm: int = H100_SMS):
    """The kernel's algorithm in plain PyTorch (tests only): the splits of
    ``plan_splits``, then ``split_attention``."""
    B, _, S = k.shape[:3]
    n_split, span = plan_splits(B, k.shape[1], S, n_sm)
    return split_attention(q, k, v, lengths, n_split, span)


def split_attention(q, k, v, lengths, n_split: int, span: int):
    """The split-K walk of the decode kernels (dense and paged) in plain
    PyTorch, for the tests: split i takes positions [i * span,
    (i + 1) * span) below min(length, S); each split's fp32 partial
    (acc = p @ v unnormalised, m, l), an empty split at m = -inf, l = 0;
    then the combine ``sum_i w_i acc_i / sum_i w_i l_i`` with
    w_i = exp(m_i - max m) and the kernels' guards (all splits empty
    gives zeros). k, v: [B, KV, S, D]."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, D) * (1.0 / math.sqrt(D))
    n = lengths.long().clamp(0, S)[:, None]
    accs, ms, ls = [], [], []
    for i in range(n_split):
        pos = torch.arange(min(i * span, S), min((i + 1) * span, S),
                           device=q.device)
        if pos.numel() == 0:
            accs.append(torch.zeros_like(qg))
            ms.append(torch.full(qg.shape[:3], float("-inf"),
                                 device=q.device))
            ls.append(torch.zeros(qg.shape[:3], device=q.device))
            continue
        s = torch.einsum("bkrd,bksd->bkrs", qg, k[:, :, pos].float())
        valid = (pos[None, :] < n)[:, None, None, :]
        s = torch.where(valid, s, float("-inf"))
        m = s.amax(dim=-1)
        safe = torch.where(torch.isinf(m), 0.0, m)
        p = torch.where(valid, torch.exp(s - safe[..., None]), 0.0)
        accs.append(torch.einsum("bkrs,bksd->bkrd", p, v[:, :, pos].float()))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    m = torch.stack(ms)                                  # [n_split, B, KV, R]
    top = m.amax(dim=0)
    safe = torch.where(torch.isinf(top), 0.0, top)
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - safe))
    den = (w * torch.stack(ls)).sum(dim=0)
    num = (w[..., None] * torch.stack(accs)).sum(dim=0)
    out = num / torch.where(den == 0.0, 1.0, den)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


@functools.cache
def _kernel():
    fn = build.load("decode_attention").decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k, v, lengths):
    """q: [B, H, D] (H a multiple of KV); k/v: [B, KV, S, D], any strides
    with a contiguous last dim; lengths: [B] int32 (keys at positions >=
    length are masked; 0 gives zeros). Returns [B, H, D] in q.dtype.

    On CUDA this is two launches (the split-K pass over ``plan_splits``'s
    grid, then the combine) into a workspace allocated here; no host
    sync, so the call can be captured in a CUDA graph."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    build.check_no_grad("decode_attention", q, k, v)
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    n_split, span = plan_splits(B, KV, S, sm_count(q.device.index))
    # partials: acc [B*H, n_split, D], then m and l [B*H, n_split], fp32
    ws = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                     device=q.device)
    ks, vs = k.stride(), v.stride()
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ws.data_ptr(), _DTYPE_CODES[q.dtype], B, H, KV,
            D, S, n_split, span, ks[0], ks[2], ks[1], vs[0], vs[2], vs[1],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
