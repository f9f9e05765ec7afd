"""Public wrappers over the attention and SSD kernels, in the model's
layouts.

PyTorch counterpart of ``repro.kernels.ops``. Each op pads to the
reference's block multiples and converts from the model's [B, S, H, D]
convention exactly as the reference does, so odd shapes give the
reference's answers, quirks included. There is no ``interpret`` switch:
like every kernel wrapper of the port, the kernels dispatch by device
(the plain PyTorch version for CPU tensors, the Hopper kernel for CUDA
tensors, an exception otherwise). Layout changes are views: the kernels
take strided K/V and write their output in the caller's layout.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.ssm import pad_time, ssd_chunked

# the reference's block sizes (repro/kernels/{flash,decode}_attention.py)
FLASH_BLK_Q = 128
FLASH_BLK_K = 128
DECODE_BLK_K = 128


def flash_attention_bshd(q, k, v, *, causal: bool = True):
    """Model-layout flash attention: q [B,Sq,H,D], k/v [B,Sk,KV,D] ->
    [B,Sq,H,D].

    As in the reference, Sq and Sk are zero-padded to multiples of their
    blocks (``min(128, max(16, S))``): padded query rows are dropped, and
    padded key rows are zero vectors that the causal mask (positions from
    0) hides from every real query when Sq == Sk. Without the causal mask
    they would be attended, so non-causal calls need a block-aligned Sk.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    blk_q = min(FLASH_BLK_Q, max(16, Sq))
    blk_k = min(FLASH_BLK_K, max(16, Sk))
    pad_q = (-Sq) % blk_q
    pad_k = (-Sk) % blk_k
    if not causal and pad_k:
        raise ValueError("non-causal flash attention requires a "
                         f"block-aligned Sk (Sk={Sk}, block {blk_k})")
    qt = pad_time(q, pad_q).transpose(1, 2)
    kt = pad_time(k, pad_k).transpose(1, 2)
    vt = pad_time(v, pad_k).transpose(1, 2)
    out = _fa.flash_attention(qt, kt, vt, causal=causal)
    return out.transpose(1, 2)[:, :Sq]


def decode_attention_bshd(q, k, v, lengths):
    """Decode: q [B,1,H,D], cache k/v [B,S,KV,D], lengths [B] int32 ->
    [B,1,H,D]. The cache is zero-padded to a multiple of
    ``min(128, S)`` positions, as in the reference."""
    S = k.shape[1]
    blk_k = min(DECODE_BLK_K, S)
    pad_k = (-S) % blk_k
    kt = pad_time(k, pad_k).transpose(1, 2)
    vt = pad_time(v, pad_k).transpose(1, 2)
    out = _da.decode_attention(q[:, 0], kt, vt, lengths)
    return out[:, None]


def ssd(x, dt, A, B, C, chunk: int = 128, initial_state=None):
    """SSD scan with ``models.ssm.ssd_chunked``'s signature: x [b,L,H,P],
    dt [b,L,H], A [H], B/C [b,L,G,N] -> (y [b,L,H,P], final_state
    [b,H,P,N]), both in x.dtype.

    Every call from a zero state (``initial_state=None``) runs the SSD
    kernel, with L zero-padded to a multiple of ``min(chunk, L)``. A call
    that continues from a state (an incremental prefill) runs
    ``ssd_chunked``, as the reference's op does: the kernel, like the
    Pallas one, owns only the scan from zero; this is the reference's
    semantics, not a fallback on failure.
    """
    if initial_state is not None:
        return ssd_chunked(x, dt, A, B, C, chunk, initial_state)
    L = x.shape[1]
    Q = min(chunk, L)
    pad = (-L) % Q
    x, dt, B, C = (pad_time(t, pad) for t in (x, dt, B, C))
    y, h = _ssd.ssd_scan(x, dt, A, B, C, chunk=Q)
    return y[:, :L], h
