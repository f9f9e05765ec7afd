"""Blocked flash attention: GQA, causal or not, fp32 online softmax.

``flash_attention`` is the wrapper. On CUDA tensors it launches the
hand-written Hopper kernel (``csrc/flash_attention.cu``, the port of the
Pallas kernel ``repro/kernels/flash_attention.py``) on the current
stream; on CPU tensors it runs ``flash_attention_ref``, the plain PyTorch
version beside it. There is no fallback: a kernel that fails to build or
launch raises. ``flash_attention.launches`` counts kernel launches
(plain-version calls do not count).

bf16 runs its products on the tensor cores (wgmma) and rounds the softmax
weights P to bf16 before ``P @ V``, where the plain version keeps them in
fp32; its operands need 16-byte rows (strides multiples of 8 elements,
16-byte aligned data), or the wrapper raises. fp32 runs on the CUDA cores.

The causal mask is the kernel's, not ``kernels/ref.py``'s: q and k
positions both count from 0 (``k_pos <= q_pos``), as in
``torch.nn.functional.scaled_dot_product_attention(is_causal=True)``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)   # the kernel's instantiations


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B,H,Sq,D] and k/v [B,KV,Sk,D]; got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, _, D = q.shape
    Bk, KV, _, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or KV == 0 or H % KV != 0 \
            or k.shape[2] == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all operands must lie on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous in their last dim")


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain PyTorch version: the full fp32 score matrix, the kernel's
    causal mask (positions from 0) and its -inf guards."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, Sq, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bkrqd,bksd->bkrqs", qg, k.float())
    if causal:
        keep = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(keep, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    safe = torch.where(torch.isinf(m), 0.0, m)
    p = torch.where(torch.isinf(s), 0.0, torch.exp(s - safe))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkrqs,bksd->bkrqd", p, v.float()) \
        / torch.where(denom == 0.0, 1.0, denom)
    return out.reshape(B, H, Sq, D).to(q.dtype)


@functools.cache
def _kernel():
    fn = build.load("flash_attention").flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B, H, Sq, D]; k, v: [B, KV, Sk, D] (H a multiple of KV), any
    strides with a contiguous last dim, Sk > 0 -> [B, H, Sq, D] in
    q.dtype, laid out like q. Query head h attends KV head h // (H // KV).
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    build.check_no_grad("flash_attention", q, k, v)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}; got {D}")
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and (
            any(t.stride(i) % 8 for t in (q, k, v, out) for i in (0, 1, 2))
            or any(t.data_ptr() % 16 for t in (q, k, v, out))):
        raise ValueError(f"bf16 operands must have 16-byte aligned rows for "
                         f"the kernel (strides {q.stride()}, {k.stride()}, "
                         f"{v.stride()})")
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)]
    strides = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, KV, D, Sq, Sk, int(causal),
            ctypes.addressof(strides),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
