"""Distributed flash-decoding over a sequence-sharded KV cache.

Counterpart of ``repro.parallel.distributed_attention``. Each rank holds
a slice of the cache's sequence (``cache_specs`` under a ``cache_seq``
rule) and reduces it to a shard-local partial: a per-head max ``m``,
denominator ``l`` and weighted output ``o``. One ``pmax`` and two
``psum`` over the sequence axis combine them:

    o = Σ_s exp(m_s - m*) · o_s / Σ_s exp(m_s - m*) · l_s

The reference runs this as a ``shard_map`` program; here the caller is
already the rank, and passes its own cache shard and that shard's key
positions. The partials are plain torch, as the reference's are plain
jnp: no Pallas kernel is involved. They take S query rows, each masked
by its own position: a single token's decode (S = 1, the reference's
``flash_decode``) and a multi-token extension alike, where the
reference attends the whole cache plainly and GSPMD gathers its keys.
The partials move ``B·S·H·(D+2)`` floats and the cache moves not at
all. The masking sequence is the
reference's, literally: ``NEG_INF`` is finite (-2**20), so a shard
whose every key is masked has ``m = -2**20``, ``l = Sl`` and a junk
``o``, and its weight ``exp(m - m*)`` underflows to exactly 0 beside a
shard that has a real key.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import NEG_INF


def _row_mask(qpos, kpos, window):
    """[B,S,Sl]: each query row's causal (and windowed) keys of the
    shard, by its own position."""
    mask = kpos[:, None, :] <= qpos[:, :, None]
    if window is not None:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    return mask


def _local_partial(q, k, v, qpos, kpos, window, softcap):
    """Shard-local attention partials of S query rows.

    q: [B,S,KV,R,D]; k,v: [B,Sl,KV,D]; qpos [B,S]; kpos [B,Sl].
    Returns m [B,KV,R,S], l [B,KV,R,S], o [B,KV,R,S,Dv] (fp32).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkrd,bskd->bkrqs", q.float(),
                     k.float()) * scale                       # [B,KV,R,S,Sl]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = _row_mask(qpos, kpos, window)                      # [B,S,Sl]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)                                        # [B,KV,R,S]
    p = torch.exp(s - m[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkrqs,bskd->bkrqd", p, v.float())
    return m, l, o


def _combine(mesh, seq_axis, m, l, o):
    """The flash-decoding combine of the partials over ``seq_axis``: one
    ``pmax`` and two ``psum``s, whatever the partials' leading shape."""
    m_max = mesh.pmax(m, seq_axis)
    fin = torch.isfinite(m)
    corr = torch.exp(torch.where(fin, m - m_max, NEG_INF))
    corr = torch.where(fin, corr, 0.0)
    l_sum = mesh.psum(l * corr, seq_axis)
    o_sum = mesh.psum(o * corr[..., None], seq_axis)
    denom = torch.where(l_sum == 0.0, 1.0, l_sum)
    return o_sum / denom[..., None]


def flash_decode(q, k_cache, v_cache, q_positions, k_positions, *, mesh,
                 seq_axis: str = "model", batch_axis="data", window=None,
                 softcap=0.0):
    """Distributed flash-decoding, called by every rank of ``seq_axis``
    with the same queries.

    q: [B,S,H,D]; k/v_cache: this rank's shard [B,Sl,KV,Dk/Dv];
    q_positions [B,S]; k_positions: the shard's [B,Sl]. Each of the S
    query rows (one token's decode, or a multi-token extension) is
    masked by its own position, so row s attends the new rows up to its
    own and none after. ``batch_axis`` is the reference's argument,
    unused: B is already this rank's rows. Returns [B,S,H,Dv] in q's
    type, the same on every rank of the axis.
    """
    del batch_axis
    B, S, H, D = q.shape
    KV = k_cache.shape[2]
    R = H // KV
    qg = q.reshape(B, S, KV, R, D)
    m, l, o = _local_partial(qg, k_cache, v_cache, q_positions, k_positions,
                             window, softcap)
    out = _combine(mesh, seq_axis, m, l, o).to(q.dtype)       # [B,KV,R,S,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, v_cache.shape[-1])


def _mla_local_partial(q_lat, q_rope, c, kr, qpos, kpos, window, scale):
    """Shard-local absorbed-MLA partials of S query rows.

    q_lat: [B,S,H,r]; q_rope: [B,S,H,ro]; c: [B,Sl,r]; kr: [B,Sl,ro];
    qpos [B,S]; kpos [B,Sl]. Returns m,l [B,H,S], o_lat [B,H,S,r] (fp32).
    """
    s = (torch.einsum("bshr,btr->bhst", q_lat.float(), c.float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(), kr.float())) * scale
    mask = _row_mask(qpos, kpos, window)
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(torch.isfinite(s), torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o_lat = torch.einsum("bhst,btr->bhsr", p, c.float())
    return m, l, o_lat


def flash_decode_mla(q_lat, q_rope, c_cache, kr_cache, q_positions,
                     k_positions, *, mesh, seq_axis: str = "model",
                     batch_axis="data", window=None, qk_dim: int = 128):
    """Distributed flash-decoding in MLA's absorbed latent space.

    q_lat: [B,S,H,r]; q_rope: [B,S,H,ro]; c_cache / kr_cache: this
    rank's shard [B,Sl,r] / [B,Sl,ro]; q_positions [B,S]; k_positions
    the shard's [B,Sl]. Each query row is masked by its own position.
    Returns o_lat [B,S,H,r] in q_lat's type (multiply by W_uv outside).
    """
    del batch_axis
    scale = 1.0 / math.sqrt(qk_dim)
    m, l, o = _mla_local_partial(q_lat, q_rope, c_cache, kr_cache,
                                 q_positions, k_positions, window, scale)
    out = _combine(mesh, seq_axis, m, l, o)                   # [B,H,S,r]
    return out.transpose(1, 2).to(q_lat.dtype)
