"""Plain-PyTorch oracles for the kernel API, copied from
``repro.kernels.ref`` with its quirks: independent implementations that
only the tests use.

- ``ref_flash_attention``'s causal mask is aligned bottom-right
  (``tril(Sk - Sq)``: query i sees keys up to ``i + Sk - Sq``), where the
  kernel counts q and k positions both from 0; the two agree only when
  Sq == Sk.
- Rows with nothing to attend (decode length 0) give NaN, as a softmax
  over all ``-inf`` does.
- ``ref_ssd`` is the token-by-token recurrence, a Python loop over L.
"""
from __future__ import annotations

import math

import torch


def ref_flash_attention(q, k, v, *, causal: bool = True):
    """q: [B,H,Sq,D]; k,v: [B,KV,Sk,D] -> [B,H,Sq,D] (naive softmax)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    rep = H // KV
    kh = torch.repeat_interleave(k, rep, dim=1)
    vh = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kh.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh.float())
    return out.to(q.dtype)


def ref_decode_attention(q, k, v, lengths):
    """q: [B,H,D]; k,v: [B,KV,S,D]; lengths: [B] -> [B,H,D]."""
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    rep = H // KV
    kh = torch.repeat_interleave(k, rep, dim=1)
    vh = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kh.float()) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, vh.float())
    return out.to(q.dtype)


def ref_ssd(x, dt, A, B, C, chunk=None, initial_state=None):
    """Token-by-token SSD recurrence (independent of the chunked form).

    x: [b,L,H,P]; dt: [b,L,H]; A: [H]; B,C: [b,L,G,N].
    Returns (y [b,L,H,P], final_state [b,H,P,N]).
    """
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(B, rep, dim=2).float()
    Ch = torch.repeat_interleave(C, rep, dim=2).float()
    dtf = dt.float()
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * A[None, :])
        h = h * dA[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtf[:, t], Bh[:, t], x[:, t].float())
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), h.to(x.dtype)
