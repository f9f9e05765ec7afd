"""Decode attention: one query token per row against a dense KV cache,
GQA-grouped, fp32 online softmax, masked by per-row length.

``decode_attention`` is the wrapper. On CUDA tensors it launches the
hand-written Hopper kernel (``csrc/decode_attention.cu``, the port of the
Pallas kernel ``repro/kernels/decode_attention.py``) on the current
stream; on CPU tensors it runs ``decode_attention_ref``, the plain
PyTorch version beside it. There is no fallback: a kernel that fails to
build or launch raises. ``decode_attention.launches`` counts kernel
launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.cache
def _kernel():
    fn = build.load("decode_attention").decode_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k, v, lengths):
    """q: [B, H, D] (H a multiple of KV); k/v: [B, KV, S, D], any strides
    with a contiguous last dim; lengths: [B] int32 (keys at positions >=
    length are masked; 0 gives zeros). Returns [B, H, D] in q.dtype."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    # the kernel copies cache rows in 16-byte vectors
    vec = 16 // k.element_size()
    if D % vec or any(st % vec for st in (*k.stride()[:3], *v.stride()[:3])) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"k/v rows must be 16-byte aligned for the kernel "
                         f"(head dim {D}, strides {k.stride()}, "
                         f"{v.stride()} in {k.dtype})")
    out = torch.empty_like(q)
    ks, vs = k.stride(), v.stride()
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[q.dtype], B, H, KV, D, S,
            ks[0], ks[2], ks[1], vs[0], vs[2], vs[1],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
