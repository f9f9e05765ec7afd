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
fp32; its operands need 16-byte rows (D and strides multiples of 8
elements, 16-byte aligned data), and operands without them are copied
into zero-padded rows first (``pad_head_dim``). fp32 runs on the CUDA
cores.

The kernel takes every head dim up to ``MAX_HEAD_DIM`` (256): it is built
at the widths ``KERNEL_WIDTHS`` and runs a D on the smallest width >= D,
the columns past D zero. Above 256 the wrapper raises: the kernel keeps
each row's output accumulator in registers (ROADMAP B).

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
# csrc/flash_attention.cu's kWidths: the head dims the kernel is built at
KERNEL_WIDTHS = (64, 80, 96, 112, 128, 160, 192, 256)
MAX_HEAD_DIM = KERNEL_WIDTHS[-1]


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
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, KV, H // KV, Sq, D) * scale
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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pad_head_dim(*ts, multiple: int = 8):
    """Copies of ``ts`` in zero-padded contiguous buffers whose last dim is
    the head dim rounded up to ``multiple`` (8 bf16 elements: a 16-byte
    row). Zero columns add nothing to q . k, and give output columns that
    the padded route drops."""
    D = ts[0].shape[-1]
    Dp = -(-D // multiple) * multiple
    out = []
    for t in ts:
        buf = t.new_zeros((*t.shape[:-1], Dp))
        buf[..., :D] = t
        out.append(buf)
    return out


def _rows16(*ts):
    """Whether every operand has 16-byte rows for the bf16 kernel."""
    return all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
               and all(t.stride(i) % 8 == 0 for i in range(t.dim() - 1))
               for t in ts)


def _launch(q, k, v, causal, scale_dim):
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    strides = [t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)]
    strides = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, H, KV, D, scale_dim, Sq, Sk,
            int(causal), ctypes.addressof(strides),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    return out


def padded_call(fn, q, k, v, causal):
    """The route of bf16 operands without 16-byte rows: ``fn(q, k, v,
    causal, scale_dim)`` (the kernel's launch) on ``pad_head_dim`` copies
    with the true head dim for the scale, its padding columns dropped
    into an output laid out like q."""
    D = q.shape[-1]
    qp, kp, vp = pad_head_dim(q, k, v)
    out = torch.empty_like(q)
    out.copy_(fn(qp, kp, vp, causal, D)[..., :D])
    return out


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B, H, Sq, D]; k, v: [B, KV, Sk, D] (H a multiple of KV), any
    strides with a contiguous last dim, Sk > 0, D <= ``MAX_HEAD_DIM`` ->
    [B, H, Sq, D] in q.dtype, laid out like q. Query head h attends KV
    head h // (H // KV).
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    build.check_no_grad("flash_attention", q, k, v)
    D = q.shape[-1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD_DIM} "
                         f"(its output accumulator lives in registers; "
                         f"ROADMAP B); got {D}")
    if q.dtype == torch.bfloat16 and not _rows16(q, k, v):
        out = padded_call(_launch, q, k, v, causal)
    else:
        out = _launch(q, k, v, causal, scale_dim=D)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
