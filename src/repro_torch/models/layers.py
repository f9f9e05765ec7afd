"""Model primitives: norms, rotary embeddings, attention (GQA / MLA), MLPs.

PyTorch counterpart of ``repro.models.layers``: plain functions on
tensors, parameters in nested dicts with the reference's keys and
layouts (``wq`` is ``[d, H, hd]``, ``wo`` is ``[H*hd, d]``), initialised
from an explicit ``torch.Generator``. Attention is the same chunked fp32
path with GQA head grouping and the same masks.

Where JAX scatters with ``mode="drop"`` (an out-of-range index is
silently skipped), the port writes at a fixed shape instead: the paged
pool holds a scratch block at index ``n_blocks`` that takes the dropped
rows (on the card an out-of-range index corrupts memory or traps; a
dense-cache write keeps only the rows that land). Cache and pool writes
here are IN PLACE (the reference rebuilt the arrays functionally); the
updated tensors are also returned, so call sites read like the
reference.

What depends on a step's inputs but not on the layer — rope's ``cos`` /
``sin`` (``rope_tables``) and the paged write index, lengths and int32
tables (``paged_step_meta``) — is computed once per step by the caller
and passed down, the same ops on the same inputs, where XLA's CSE
removes the per-layer repeats in the reference.

JAX promotes an einsum of two float types (bf16 x fp32 -> fp32, the
bf16 operand widened exactly); ``torch.einsum`` refuses mixed types. The
reference's audio encoder runs fp32 frames through bf16 weights, so the
einsums of a GQA layer and an MLP promote explicitly (``_einsum``).

Under sharding rules (``parallel.sharding.use_rules``) a layer runs at
this rank's shard of the reference's sharded step, its geometry read
from the weights' shapes (``Heads``, ``split_axis``): query heads (and
KV heads) split over ``heads`` with a row-parallel ``wo``, ``d_ff`` over
``ffn`` with a row-parallel ``w_down``, each ending in a ``psum`` where
GSPMD inserts one in the reference; a cache's sequence split over
``cache_seq`` (``cache_span``, ``write_slots``) is attended by
distributed flash-decoding.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import gelu as _gelu_kernel
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.parallel import sharding as SH

NEG_INF = -2.0 ** 20  # large-negative that is safe in bf16 softmax


# --------------------------------------------------------------------------- init
#: the fp32 elements of one chunk of a weight draw (256 MiB): the draw's
#: only transient, and large enough that a chunk's launches cost nothing
DRAW_ELEMS = 1 << 26


_draws = threading.local()


@contextlib.contextmanager
def drawing_shards(sink):
    """Inside, on this thread, ``new_leaf`` and ``draw_into`` defer to
    ``sink`` (a ``parallel.sharding.ShardDraw``): a leaf whose shard it
    keeps is a ``meta`` tensor, and each chunk drawn for it goes to
    ``sink.take``, which keeps this rank's part (``transformer.
    init_params_shard``)."""
    prev = getattr(_draws, "sink", None)
    _draws.sink = sink
    try:
        yield sink
    finally:
        _draws.sink = prev


def new_leaf(shape, dtype, device) -> torch.Tensor:
    """``torch.empty`` of a weight leaf ``draw_into`` will fill, or what
    the sink of ``drawing_shards`` makes of it."""
    sink = getattr(_draws, "sink", None)
    if sink is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return sink.new_leaf(tuple(shape), dtype, device)


def draw_into(w, draw, scale: float, rows: Optional[int] = None):
    """Fill ``w`` in place with ``draw(t) * scale``: fp32 chunks ``t`` of
    the rows of ``w`` viewed as ``[-1, w.shape[-1]]``, each drawn by
    ``draw``, scaled in place and cast into ``w``'s type. A chunk is at
    most ``rows`` rows (a layer's slice of a stacked leaf) and about
    ``DRAW_ELEMS`` elements (a multiple of 16 rows), so the draw holds one
    fp32 chunk beside its result, where a whole-leaf fp32 draw of a stack
    held two of the stack's size. On the CPU a chunked draw reads the
    generator as one draw of the whole does (the uniform fill element by
    element, the normal fill in blocks of 16 from a uniform fill), so
    the chunks do not change the values; on the card they do. A ``meta``
    ``w`` is left as it is, unless ``drawing_shards``' sink is drawing:
    its chunks are then drawn on the sink's device, the same calls on
    the same generator, and handed to ``sink.take``."""
    sink = None
    if w.device.type == "meta":
        sink = getattr(_draws, "sink", None)
        if sink is None or not sink.drawing:
            return w
    flat = w.view(-1, w.shape[-1])
    step = max(16, DRAW_ELEMS // flat.shape[1] // 16 * 16)
    if rows is not None:
        step = min(step, rows)
    for i in range(0, flat.shape[0], step):
        n = min(step, flat.shape[0] - i)
        t = torch.empty((n, flat.shape[1]), dtype=torch.float32,
                        device=w.device if sink is None else sink.device)
        draw(t)
        t.mul_(scale)
        if sink is None:
            flat[i:i + n].copy_(t)
        else:
            sink.take(w, i, t)
        del t  # before the next chunk is allocated
    return w


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype, *,
               lead=()) -> torch.Tensor:
    """Truncated-normal fan-in init; out_shape may be a tuple (heads, dim).
    ``lead`` prepends stacked-layer dims (the ``[L, ...]`` layout). Drawn
    straight into ``dtype``, a layer's ``[in_dim, ...]`` slice at a time
    (``draw_into``), each chunk sampled in place (``truncated_normal_``;
    torch's ``trunc_normal_`` may redraw rejections into temporaries of
    the whole tensor's size)."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    w = new_leaf((*lead, in_dim, *out_shape), dtype, gen.device)
    return draw_into(w.view(-1, math.prod(out_shape)),
                     lambda t: truncated_normal_(t, gen),
                     1.0 / math.sqrt(in_dim), rows=in_dim).view(w.shape)


_ERF2 = math.erf(2.0 / math.sqrt(2.0))


def truncated_normal_(t, gen):
    """A standard normal truncated to [-2, 2], in place, as
    ``jax.random.truncated_normal`` draws it: sqrt(2) * erfinv of a
    uniform in (erf(-2 / sqrt 2), erf(2 / sqrt 2)), with no temporary."""
    t.uniform_(-_ERF2, _ERF2, generator=gen).erfinv_()
    return t.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


# --------------------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, dtype, device, *, lead=()):
    p = {"scale": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device)}
    if cfg.norm_kind == "layernorm":
        p["bias"] = torch.zeros((*lead, cfg.d_model), dtype=dtype,
                                device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_norm_dim(x, eps=1e-6):
    """Scale-free RMS norm over the last dim (for qk-norm)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return y.to(x.dtype)


# --------------------------------------------------------------------------- rope
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def rope_tables(positions, dim: int, theta: float):
    """(cos, sin) of rope's angles for ``positions`` [..., S] int, each
    [..., S, 1, dim/2] (broadcast over heads). A function of the step's
    positions only: callers compute it once per step for every layer."""
    freqs = rope_freqs(dim, theta, positions.device)           # [D/2]
    angles = positions[..., :, None].float() * freqs           # [..., S, D/2]
    angles = angles[..., :, None, :]                           # over heads
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, positions, theta: float, tables=None):
    """x: [..., S, H, D] (D even); positions: [..., S] int. ``tables``
    is ``rope_tables(positions, D, theta)`` computed beforehand (then
    ``positions`` and ``theta`` are not read)."""
    if tables is None:
        tables = rope_tables(positions, x.shape[-1], theta)
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions, dim: int):
    """Classic transformer sinusoids; positions [..., S] -> [..., S, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------- attention core
def _attn_mask(qpos, kpos, kv_len, window, causal):
    """Build [B,Qc,Sk] mask from per-batch positions.

    qpos: [B,Qc]; kpos: [B,Sk]; kv_len: [B] or None.
    """
    if causal:
        mask = kpos[:, None, :] <= qpos[:, :, None]
        if window is not None:
            mask &= kpos[:, None, :] > qpos[:, :, None] - window
    else:
        mask = torch.ones((qpos.shape[0], qpos.shape[1], kpos.shape[1]),
                          dtype=torch.bool, device=qpos.device)
    if kv_len is not None:
        mask &= kpos[:, None, :] < kv_len[:, None, None]
    return mask


def _attend_block(q, k, v, qpos, kpos, kv_len, window, causal, softcap=0.0):
    """One (q-chunk x full-K) attention step with GQA grouping.

    q:[B,Qc,KV,R,D] k,v:[B,Sk,KV,D] -> out [B,Qc,KV,R,D]; fp32 softmax.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkrd,bskd->bkrqs", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = _attn_mask(qpos, kpos, kv_len, window, causal)
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkrqs,bskd->bqkrd", w, v.float())


def attention(q, k, v, *, q_positions=None, kv_len=None, window=None,
              causal=True, chunk=512, softcap=0.0, k_positions=None):
    """Chunked multi-head attention with GQA head grouping.

    q: [B,Sq,H,D]; k,v: [B,Sk,KV,D]. ``q_positions`` [B,Sq] are absolute
    positions of the queries (default arange). ``kv_len`` [B] masks
    partially-filled caches. ``k_positions`` ([Sk] or [B,Sk]) overrides K
    positions (ring buffers). Queries longer than ``chunk`` run chunk by
    chunk so the live score tensor stays bounded. Returns [B,Sq,H,D] in
    q.dtype.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    R = H // KV
    qg = q.reshape(B, Sq, KV, R, D)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32,
                                   device=dev).expand(B, Sq)
    if k_positions is None:
        kpos = torch.arange(Sk, dtype=torch.int32, device=dev).expand(B, Sk)
    else:
        kpos = torch.broadcast_to(k_positions, (B, Sk)).to(torch.int32)
    outs = []
    for c0 in range(0, Sq, chunk):
        outs.append(_attend_block(qg[:, c0:c0 + chunk], k, v,
                                  q_positions[:, c0:c0 + chunk], kpos,
                                  kv_len, window, causal, softcap))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


# ------------------------------------------------------------------ GQA attention
def _einsum(eq, x, w):
    """``torch.einsum`` of an activation and a weight; where their float
    types differ (the audio encoder's fp32 frames through bf16 weights,
    and the cross K/V computed from its output), both are promoted as
    JAX promotes a mixed einsum."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.einsum(eq, x, w)


# ------------------------------------------------------- a rank's shard
class Heads:
    """This rank's attention heads under the sharding rules installed
    (``parallel.sharding.use_rules``): ``n`` local query heads, read from
    the query weight's shape; ``axis``, the mesh axis they are split over
    (None when this rank holds every head); ``h0``, the first global
    head it holds. Where the K/V heads stay whole though the query heads
    are split (KV does not divide the axis), ``kv`` picks the global KV
    head of each local query head (``h // (H // KV)``): a slice where
    they form whole groups, else an index. Otherwise ``kv`` is None."""

    def __init__(self, cfg: ModelConfig, n: int, n_kv: Optional[int] = None):
        self.n, self.axis, self.h0, self.kv, self.mesh = n, None, 0, None, None
        rules = SH.current_rules()
        if rules is None or n == cfg.num_heads:
            return
        self.axis, self.mesh = rules["heads"], rule_mesh(rules)
        self.h0 = self.mesh.axes_index(self.axis) * n
        if n_kv is None or n_kv < cfg.num_kv_heads:
            return                           # K/V heads split alike
        R = cfg.num_heads // cfg.num_kv_heads
        lo, hi = self.h0 // R, (self.h0 + n - 1) // R + 1
        if hi - lo == 1 or (self.h0 % R == 0 and n % R == 0):
            self.kv = slice(lo, hi)
        else:
            self.kv = (torch.arange(self.h0, self.h0 + n) // R)

    def select_kv(self, *ts):
        """K/V tensors [B, S, KV, D] at the heads this rank's queries
        read (the tensors themselves where no selection is needed)."""
        if self.kv is None:
            return ts
        return tuple(t[:, :, self.kv.to(t.device)
                       if torch.is_tensor(self.kv) else self.kv] for t in ts)

    def local(self, t, dim=2):
        """This rank's heads of a per-head tensor that holds them all
        (replicated over ``axis``: its cotangent is summed there,
        ``enter``)."""
        if self.axis is None or t.shape[dim] == self.n:
            return t
        return self.enter(t).narrow(dim, self.h0, self.n)

    def enter(self, t):
        """``t``, replicated over ``axis``, entering this rank's heads:
        the identity, whose backward sums the cotangent over ``axis``
        (``parallel.mesh``'s convention)."""
        return t if self.axis is None else self.mesh.enter(t, self.axis)

    def reduce(self, y):
        """The output projection's partial sums over the split heads
        (a row-parallel ``wo``) summed across ``axis``."""
        return y if self.axis is None else self.mesh.psum(y, self.axis)


def rule_mesh(rules):
    """The ``parallel.mesh.RankMesh`` a rule table drives ops on."""
    mesh = rules.get("mesh")
    if mesh is None:
        raise ValueError("sharding rules that split a tensor need this "
                         "rank's mesh under rules['mesh']")
    return mesh


def split_axis(logical: str, local: int, full: int):
    """The mesh axis a dimension of ``full`` entries is split over under
    the installed rules, where this rank holds ``local`` of them; None
    where it holds them all."""
    rules = SH.current_rules()
    if rules is None or local == full:
        return None
    if rules.get(logical) is None:
        raise ValueError(f"{local} of {full} entries held, but no "
                         f"{logical!r} rule splits them")
    return rules[logical]


def psum_split(y, logical: str, local: int, full: int):
    """``y``, a partial sum over this rank's ``local`` of ``full``
    entries of a contracted dim, summed across the axis that splits them
    (``y`` itself when nothing is split)."""
    axis = split_axis(logical, local, full)
    return y if axis is None else rule_mesh(SH.current_rules()).psum(y, axis)


def enter_split(x, logical: str, local: int, full: int):
    """``x``, replicated, entering a computation over this rank's
    ``local`` of ``full`` entries: ``RankMesh.enter`` over the axis that
    splits them (``x`` itself when nothing is split)."""
    axis = split_axis(logical, local, full)
    return x if axis is None else rule_mesh(SH.current_rules()).enter(x,
                                                                      axis)


def cache_span(m_local: int):
    """(M, lo, axis) of a cache whose sequence this rank holds ``m_local``
    slots of: the whole cache's capacity, the first slot this rank holds
    and the mesh axis the sequence is split over (``cache_seq``), or
    ``(m_local, 0, None)`` when it holds every slot."""
    rules = SH.current_rules()
    axis = rules.get("cache_seq") if rules else None
    if axis is None:
        return m_local, 0, None
    mesh = rule_mesh(rules)
    return (m_local * mesh.axes_size(axis),
            m_local * mesh.axes_index(axis), axis)


def write_slots(t, slots, vals):
    """``t[b, slots[b, s]] = vals[b, s]`` in place, for a cache leaf
    ``t`` [B, m, ...] holding this rank's slots of the sequence
    (``cache_span``): a slot outside them is not written. When S is
    longer than the whole cache (a ring) only the trailing M columns are
    written: the reference sends the others out of bounds and drops
    them."""
    B, S = slots.shape
    M, lo, _ = cache_span(t.shape[1])
    if t.device.type == "meta":     # no data to write (a dry run)
        return
    s0 = max(S - M, 0)
    sl, vv = slots[:, s0:], vals[:, s0:].to(t.dtype)
    bidx = torch.arange(B, device=slots.device)[:, None].expand_as(sl)
    if M == t.shape[1]:
        t[bidx, sl] = vv
        return
    loc = sl - lo
    own = (loc >= 0) & (loc < t.shape[1])
    t[bidx[own], loc[own]] = vv[own]


def init_gqa(cfg: ModelConfig, gen, dtype, *, lead=()):
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, (cfg.num_heads, hd), dtype,
                         lead=lead),
        "wk": dense_init(gen, cfg.d_model, (cfg.num_kv_heads, hd), dtype,
                         lead=lead),
        "wv": dense_init(gen, cfg.d_model, (cfg.num_kv_heads, hd), dtype,
                         lead=lead),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype,
                         lead=lead),
    }


def _qkv(p, x, cfg: ModelConfig, positions, rope=None, heads=None):
    """q, k, v at ``heads`` (this rank's, or all of them): ``x`` enters
    the split projections (``Heads.enter``); K/V heads that stay whole
    under split query heads are computed whole and enter where this
    rank's query heads pick from them."""
    whole_kv = heads is not None and heads.kv is not None
    xs = x if heads is None else heads.enter(x)
    xkv = x if whole_kv else xs
    q = _einsum("bsd,dhk->bshk", xs, p["wq"])
    k = _einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = _einsum("bsd,dhk->bshk", xkv, p["wv"])
    if cfg.use_qk_norm:
        q, k = rms_norm_dim(q), rms_norm_dim(k)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)
    if whole_kv:
        k, v = heads.enter(k), heads.enter(v)
    return q, k, v


def apply_gqa(p, x, cfg: ModelConfig, *, positions, cache=None, slots=None,
              k_positions=None, window=None, kv_override=None, causal=True,
              attend_fresh=False, rope=None, impl="gather", kv_lengths=None):
    """GQA/MQA attention with optional KV-cache write-then-attend.

    x: [B,S,d]; positions [B,S] absolute. ``cache`` is None (train) or a
    per-layer dict {"k": [B,M,KV,hd], "v": ...}, written IN PLACE at
    ``slots`` [B,S]. When S > M (a ring buffer shorter than the call),
    only the trailing M columns are written: the leading S - M are the
    rows ``transformer._cache_meta`` pushes out of bounds and the
    reference drops. ``k_positions`` [B,M] is the (already-updated)
    absolute position of each cache row. ``attend_fresh`` (prefill)
    attends this call's own K/V while the cache write happens on the side.
    ``rope`` is ``rope_tables(positions, ...)``, computed once per call of
    the stack (None computes it here).

    ``impl="kernel"`` sends a single-token decode's attention through the
    decode-attention kernel (kernels/decode_attention.py) on a transposed
    VIEW of the cache (``[B, M, KV, hd]`` as ``[B, KV, M, hd]``, no copy),
    with lengths = position + 1: the kernel's guards of the reference's
    paged path (causal, no window, no logit softcap). Without a window
    the cache is no ring (its capacity is the logical length), so a row's
    slot is its position and the rows below the length are exactly the
    keys the mask keeps. Every other call attends with ``attention``
    ("gather"), as the reference does.

    ``kv_override``: (k, v) [B, Sk, KV, hd] for cross-attention, which
    ignores the cache path and attends every key (``causal=False``).
    Under ``impl="kernel"`` a single-token query attends them through the
    decode-attention kernel on transposed views, with ``kv_lengths`` [B]
    int32 = Sk for every row (made once per step by the caller): for one
    query a non-causal attention over all Sk keys is exactly decode
    attention at length Sk.
    Under sharding rules (``parallel.sharding.use_rules``) the layer
    runs at this rank's heads (``Heads``, from the weights' shapes), and
    the row-parallel ``wo`` ends in a ``psum`` over the heads' axis. A
    cache whose sequence is split (``cache_seq``) takes only the slots
    this rank holds (``write_slots``); a decode over it, of one token or
    of S > 1 (a chunk extension), combines the ranks' partials by
    distributed flash-decoding (``_decode_split_cache``), each query row
    masked by its own position: with ``rules["flash_decode"]`` as the
    reference does for one token, and otherwise too, where the reference
    attends the whole cache plainly and lets GSPMD gather its keys: the
    same attention, with no cache gathered. Where the query heads split
    over the sequence's axis, the queries are gathered first and this
    rank keeps its heads of the result. Cross-attention's queries enter
    this rank's heads too, as do cross K/V kept whole under split query
    heads; the cross K/V are never sequence-split, so they never take
    the flash-decoding branch.
    Returns (out [B,S,d], cache_or_None).
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    heads = Heads(cfg, p["wq"].shape[-2], p["wk"].shape[-2])
    if kv_override is not None:
        q = _einsum("bsd,dhk->bshk", heads.enter(x), p["wq"])
        k, v = kv_override
        if heads.kv is not None:    # whole K/V read by split query heads
            k, v = heads.enter(k), heads.enter(v)
        k, v = heads.select_kv(k, v)
        if impl == "kernel" and S == 1:
            if kv_lengths is None:
                raise ValueError("the cross-attention kernel route needs "
                                 "kv_lengths")
            out = decode_attention(q[:, 0].to(k.dtype).contiguous(),
                                   k.transpose(1, 2), v.transpose(1, 2),
                                   kv_lengths)[:, None].to(q.dtype)
        else:
            out = attention(q, k, v, causal=False, chunk=512)
        out = out.reshape(B, S, heads.n * hd)
        return heads.reduce(_einsum("bsh,hd->bsd", out, p["wo"])), None
    q, k, v = _qkv(p, x, cfg, positions, rope, heads)
    if cache is None:
        out = attention(q, *heads.select_kv(k, v), q_positions=positions,
                        window=window, causal=causal,
                        softcap=cfg.logit_softcap)
    else:
        ck, cv = cache["k"], cache["v"]
        write_slots(ck, slots, k)
        write_slots(cv, slots, v)
        M, _, seq_axis = cache_span(ck.shape[1])
        rules = SH.current_rules()
        if attend_fresh:  # prefill: full fresh sequence, windowed mask
            out = attention(q, *heads.select_kv(k, v), q_positions=positions,
                            window=window, causal=causal,
                            softcap=cfg.logit_softcap)
        elif seq_axis is not None and (
                M > ck.shape[1] or (S == 1 and rules.get("flash_decode"))):
            out = _decode_split_cache(heads, q, ck, cv, positions,
                                      k_positions, window, cfg, seq_axis)
        elif (impl == "kernel" and S == 1 and causal and window is None
              and not cfg.logit_softcap and heads.kv is None):
            lengths = (positions[:, 0] + 1).to(torch.int32)
            out = decode_attention(q[:, 0].to(ck.dtype).contiguous(),
                                   ck.transpose(1, 2), cv.transpose(1, 2),
                                   lengths)[:, None].to(q.dtype)
        else:  # decode: attend the updated cache
            out = attention(q, *heads.select_kv(ck, cv),
                            q_positions=positions, k_positions=k_positions,
                            window=window, causal=causal,
                            softcap=cfg.logit_softcap)
        cache = {"k": ck, "v": cv}
    out = out.reshape(B, S, heads.n * hd)
    return heads.reduce(_einsum("bsh,hd->bsd", out, p["wo"])), cache


def _decode_split_cache(heads, q, ck, cv, positions, k_positions, window,
                        cfg, seq_axis):
    """The attention of S query rows (one token's decode or a
    multi-token extension) over this rank's slice of a sequence-split
    cache, combined across ``seq_axis`` (``flash_decode``). Every rank of
    that axis must bring the same queries: where they hold different
    heads of it, the queries (all S rows) are gathered over the axis and
    each rank keeps its own heads of the output."""
    from repro_torch.parallel.distributed_attention import flash_decode

    mesh = rule_mesh(SH.current_rules())
    gather = heads.axis == seq_axis
    if gather:
        q = mesh.all_gather(q, seq_axis, dim=2)
    else:
        ck, cv = heads.select_kv(ck, cv)
    out = flash_decode(q, ck, cv, positions, k_positions, mesh=mesh,
                       seq_axis=seq_axis, window=window,
                       softcap=cfg.logit_softcap)
    return heads.local(out) if gather else out


def paged_step_meta(positions, block_tables, active, n_blocks: int,
                    block_size: int):
    """The per-step operands of every paged layer, at a fixed shape on
    the inputs' device: ``write`` — (blocks, offsets) [B] of each row's
    new token, where an inactive row, an unallocated (-1) or out-of-range
    table entry sends the row to the scratch block ``n_blocks``, as the
    reference sends it to its drop index (a position past the table
    clamps to the last column, as there); ``kv_len`` [B] int32 (0 for
    inactive rows); ``tables`` the block tables as contiguous int32."""
    pos = positions[:, 0]
    tables = block_tables.to(torch.int32).contiguous()
    col = torch.clamp(pos.long() // block_size, 0, tables.shape[1] - 1)
    blk = tables.long().gather(1, col[:, None])[:, 0]
    blk = torch.where(active & (blk >= 0) & (blk < n_blocks), blk, n_blocks)
    kv_len = torch.where(active, pos + 1, 0).to(torch.int32)
    return {"write": (blk, pos.long() % block_size), "kv_len": kv_len,
            "tables": tables}


def apply_gqa_paged(p, x, cfg: ModelConfig, *, positions, pool_k, pool_v,
                    block_tables, active, window=None, impl="gather",
                    meta=None, rope=None, kv_rows=None):
    """GQA decode attention against a paged block pool (write-then-attend).

    Single-token decode only: x [B,1,d]. ``pool_k/v`` are ONE layer's pool
    slices [n_blocks + 1, KV, bs, hd] (KV-head-major; the last block is
    the scratch block that takes dropped writes), updated IN PLACE;
    ``block_tables`` [B, max_blocks] int (-1 = unallocated, masked);
    ``positions`` [B,1] are the pre-write token counts; ``active`` [B]
    bool — inactive rows write into the scratch block and attend an empty
    context (garbage logits the engine ignores). All on x's device.
    ``meta`` is ``paged_step_meta`` and ``rope`` is ``rope_tables``, both
    computed once per step by ``forward_paged``; None computes them here.
    ``kv_rows`` (a replicated layer, ``core.replication.LayerHook.
    gather_kv``): x holds this rank's rows only, and ``kv_rows(k, v)``
    returns every row's new K/V, which the write (``meta["write"]``, of
    the full batch) puts into the pool, so every rank's pool stays whole.

    ``impl``: "gather" materialises the table's blocks and reuses the
    chunked fp32 attention; "kernel" calls the paged-decode kernel
    (kernels/paged_decode.py) on the real blocks, whose traffic stops at
    each request's true length. The kernel implements plain causal GQA
    only, so logit-softcap archs and sliding windows route back to
    "gather".

    Under sharding rules (``parallel.sharding.use_rules``) the layer runs
    at this rank's heads (``Heads``, from the weights' shapes) over this
    rank's rows and its own pool: where ``kv_heads`` splits the K/V heads
    the pool holds this rank's KV heads, and the kernel route launches at
    the rank's query and KV heads; where the K/V heads stay whole under
    split query heads, the pool holds them all, the new token's K/V are
    computed whole and written whole, and the layer attends on the gather
    route, each query head reading its KV head (``Heads.select_kv``), as
    ``apply_gqa`` does. The row-parallel ``wo`` ends in a ``psum`` over
    the heads' axis (``Heads.reduce``).

    Returns (out [B,1,d], pool_k, pool_v).
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError("paged path is decode-only (one token per step)")
    hd = cfg.resolved_head_dim
    n_blocks, KV, bs, _ = pool_k.shape
    n_blocks -= 1                                   # the scratch block
    if meta is None:
        meta = paged_step_meta(positions, block_tables, active, n_blocks, bs)
    heads = Heads(cfg, p["wq"].shape[-2], p["wk"].shape[-2])
    q, k, v = _qkv(p, x, cfg, positions, rope, heads)
    if k.shape[2] != KV:
        raise ValueError(f"the pool holds {KV} KV heads, the layer computes "
                         f"{k.shape[2]}")
    if kv_rows is not None:
        k, v = kv_rows(k, v)

    # ---- write the new token's K/V into its block (dropped rows land in
    # the scratch block)
    blk, off = meta["write"]
    pool_k[blk, :, off] = k[:, 0].to(pool_k.dtype)
    pool_v[blk, :, off] = v[:, 0].to(pool_v.dtype)

    kv_len = meta["kv_len"]
    if impl == "kernel" and (cfg.logit_softcap or window is not None
                             or heads.kv is not None):
        # no softcap / window in the kernel; whole K/V heads read by split
        # query heads pick their KV head on the gather route
        impl = "gather"
    if impl == "kernel":
        out = paged_decode_attention(
            q[:, 0].contiguous(), pool_k[:n_blocks], pool_v[:n_blocks],
            meta["tables"], kv_len)[:, None]
    else:
        max_blocks = block_tables.shape[1]
        tbl = torch.clamp(meta["tables"].long(), min=0)
        # gathered blocks are [B, mb, KV, bs, hd]; only the gathered
        # context is re-laid token-major, never the whole pool
        kk = pool_k[tbl].permute(0, 1, 3, 2, 4).reshape(
            B, max_blocks * bs, KV, hd)
        vv = pool_v[tbl].permute(0, 1, 3, 2, 4).reshape(
            B, max_blocks * bs, KV, hd)
        kk, vv = heads.select_kv(kk, vv)
        out = attention(q, kk, vv, q_positions=positions, kv_len=kv_len,
                        k_positions=torch.arange(max_blocks * bs,
                                                 dtype=torch.int32,
                                                 device=x.device),
                        window=window, causal=True,
                        softcap=cfg.logit_softcap)
    out = out.reshape(B, S, heads.n * hd)
    return (heads.reduce(torch.einsum("bsh,hd->bsd", out, p["wo"])), pool_k,
            pool_v)


def compute_cross_kv(p, enc_out, cfg: ModelConfig):
    """Cross-attention K/V from the encoder output (the whisper decoder's
    prefill), at the promoted type of the output and the weights. Under
    sharding rules the replicated output enters K/V heads split over
    ``kv_heads``."""
    enc_out = enter_split(enc_out, "kv_heads", p["wk"].shape[-2],
                          cfg.num_kv_heads)
    k = _einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = _einsum("bsd,dhk->bshk", enc_out, p["wv"])
    return k, v


# ------------------------------------------------------------------ MLA attention
def init_mla(cfg: ModelConfig, gen, dtype, *, lead=()):
    """``wq_a`` [d, q_rank] and ``wq_b`` [q_rank, H, nope + rope] when
    the config has a ``q_lora_rank``, else ``wq`` [d, H, nope + rope];
    ``wkv_a`` [d, kv_rank + rope], ``wk_b`` [kv_rank, H, nope], ``wv_b``
    [kv_rank, H, v] and ``wo`` [H * v, d]."""
    H = cfg.num_heads
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = dense_init(gen, cfg.d_model, cfg.q_lora_rank, dtype,
                               lead=lead)
        p["wq_b"] = dense_init(gen, cfg.q_lora_rank, (H, qk_dim), dtype,
                               lead=lead)
    else:
        p["wq"] = dense_init(gen, cfg.d_model, (H, qk_dim), dtype, lead=lead)
    p["wkv_a"] = dense_init(gen, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype,
                            lead=lead)
    p["wk_b"] = dense_init(gen, cfg.kv_lora_rank, (H, cfg.qk_nope_head_dim),
                           dtype, lead=lead)
    p["wv_b"] = dense_init(gen, cfg.kv_lora_rank, (H, cfg.v_head_dim), dtype,
                           lead=lead)
    p["wo"] = dense_init(gen, H * cfg.v_head_dim, cfg.d_model, dtype,
                         lead=lead)
    return p


def _mla_q(p, x, cfg, positions, rope, heads):
    """The queries at ``heads``: the replicated input of the head-split
    projection (``x``, or the low-rank ``x . wq_a``) enters it."""
    if cfg.q_lora_rank:
        q = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
        q = torch.einsum("bsr,rhk->bshk", heads.enter(q), p["wq_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", heads.enter(x), p["wq"])
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], positions,
                        cfg.rope_theta, rope)
    return q_nope, q_rope


def _mla_latents(p, x, cfg, positions, rope=None):
    ckr = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv = ckr[..., :cfg.kv_lora_rank]
    k_rope = apply_rope(ckr[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta, rope)[..., 0, :]
    return c_kv, k_rope


def _write_latents(cache, slots, c_kv, k_rope):
    """The latents into a per-layer cache {"c": [B,M,r], "kr": [B,M,rope]}
    at ``slots``, in place (``write_slots``: when S > M only the trailing
    M columns, the rule of ``apply_gqa``'s K/V write; on a
    sequence-split cache only this rank's slots)."""
    write_slots(cache["c"], slots, c_kv)
    write_slots(cache["kr"], slots, k_rope)


def _mla_heads(p, cfg):
    """(heads, wk_b, wv_b) at this rank's query heads: the absorbed
    per-head weights are cut to them where they are whole."""
    heads = Heads(cfg, p["wq_b" if cfg.q_lora_rank else "wq"].shape[-2])
    return heads, heads.local(p["wk_b"], 1), heads.local(p["wv_b"], 1)


def apply_mla_prefill(p, x, cfg: ModelConfig, *, positions, cache=None,
                      slots=None, window=None, rope=None):
    """MLA in the expanded (compute-friendly) form for train/prefill:
    K and V expanded per head from the latent, causal attention over this
    call's sequence. ``cache``: None or a per-layer {"c": [B,M,r], "kr":
    [B,M,rope]}, where this call's latents are written at ``slots`` (in
    place). ``rope`` is ``rope_tables`` at the rope dim (never the GQA
    head dim's). Under sharding rules it runs at this rank's heads, the
    latents whole (or this rank's slots of a sequence-split cache), and
    ``wo`` ends in a ``psum``. Returns (out, cache_or_None)."""
    B, S, _ = x.shape
    heads, wk_b, wv_b = _mla_heads(p, cfg)
    H = heads.n
    q_nope, q_rope = _mla_q(p, x, cfg, positions, rope, heads)
    c_kv, k_rope = _mla_latents(p, x, cfg, positions, rope)
    # the latents are whole on every rank and enter its heads
    c_in = heads.enter(c_kv)
    k_nope = torch.einsum("bsr,rhk->bshk", c_in, wk_b)
    v = torch.einsum("bsr,rhk->bshk", c_in, wv_b)
    k_rope_b = heads.enter(k_rope)[:, :, None, :].expand(
        B, S, H, cfg.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_b], -1)
    out = attention(q, k, v, q_positions=positions, window=window)
    out = out.reshape(B, S, H * cfg.v_head_dim)
    out = heads.reduce(torch.einsum("bsh,hd->bsd", out, p["wo"]))
    if cache is not None:
        _write_latents(cache, slots, c_kv, k_rope)
    return out, cache


def apply_mla_decode(p, x, cfg: ModelConfig, *, positions, cache, slots,
                     k_positions, window=None, rope=None):
    """MLA decode in the ABSORBED form (DeepSeek-V2): ``wk_b`` is folded
    into the query (``q_lat = q_nope . wk_b``, in x's type), the scores
    run over the cached ``[c | kr]`` in fp32, and the latent output
    (narrowed to x's type, as the reference narrows it) goes through
    ``wv_b``. The new latents are written at ``slots`` (in place) BEFORE
    attending; ``k_positions`` [B,M] are the already-updated absolute row
    positions. Under sharding rules it runs at this rank's heads; over a
    sequence-split cache the latent attention of one token or of S > 1
    (a chunk extension) is combined across the ranks by
    ``flash_decode_mla``, each query row masked by its own position
    (with ``rules["flash_decode"]``, as the reference for one token, or
    without it, as ``apply_gqa``), its output rounded to ``q_lat``'s
    type and widened. Returns (out, cache)."""
    B, S, _ = x.shape
    heads, wk_b, wv_b = _mla_heads(p, cfg)
    q_nope, q_rope = _mla_q(p, x, cfg, positions, rope, heads)
    c_new, kr_new = _mla_latents(p, x, cfg, positions, rope)
    _write_latents(cache, slots, c_new, kr_new)
    m_local = cache["c"].shape[1]
    M, _, seq_axis = cache_span(m_local)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk_b)
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    kpos = torch.broadcast_to(k_positions, (B, m_local)).to(torch.int32)
    rules = SH.current_rules()
    if seq_axis is not None and (
            M > m_local or (S == 1 and rules.get("flash_decode"))):
        from repro_torch.parallel.distributed_attention import (
            flash_decode_mla)
        mesh = rule_mesh(rules)
        gather = heads.axis == seq_axis
        ql, qr = ((mesh.all_gather(q_lat, seq_axis, 2),
                   mesh.all_gather(q_rope, seq_axis, 2)) if gather
                  else (q_lat, q_rope))
        o_lat = flash_decode_mla(ql, qr, cache["c"], cache["kr"], positions,
                                 kpos, mesh=mesh, seq_axis=seq_axis,
                                 window=window, qk_dim=qk_dim).float()
        if gather:
            o_lat = heads.local(o_lat)
    else:
        cc = cache["c"].float()
        s = (torch.einsum("bshr,btr->bhst", q_lat.float(), cc)
             + torch.einsum("bshk,btk->bhst", q_rope.float(),
                            cache["kr"].float())) * (1.0 / math.sqrt(qk_dim))
        mask = _attn_mask(positions, kpos, None, window, True)
        s = torch.where(mask[:, None, :, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", w, cc)
    out = torch.einsum("bshr,rhk->bshk", o_lat.to(x.dtype), wv_b)
    out = out.reshape(B, S, heads.n * cfg.v_head_dim)
    return heads.reduce(torch.einsum("bsh,hd->bsd", out, p["wo"])), cache


# ------------------------------------------------------------------------- MLPs
def init_mlp(cfg: ModelConfig, gen, dtype, d_ff: Optional[int] = None, *,
             lead=()):
    d_ff = d_ff or cfg.d_ff
    if cfg.ffn_kind == "gelu":
        return {"w_up": dense_init(gen, cfg.d_model, d_ff, dtype, lead=lead),
                "w_down": dense_init(gen, d_ff, cfg.d_model, dtype,
                                     lead=lead)}
    return {"w_gate": dense_init(gen, cfg.d_model, d_ff, dtype, lead=lead),
            "w_up": dense_init(gen, cfg.d_model, d_ff, dtype, lead=lead),
            "w_down": dense_init(gen, d_ff, cfg.d_model, dtype, lead=lead)}


class _GeluGrad(torch.autograd.Function):
    """``_gelu`` under autograd: the forward and JAX's VJP of its op chain
    through ``kernels.gelu`` (one launch each on the card), saving only x
    (the backward recomputes the chain)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_kernel.gelu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _gelu_kernel.gelu_grad(x, g.contiguous())


def _gelu(x):
    """``jax.nn.gelu`` (tanh form, its default) as XLA lowers it, each op
    rounded to x's type (``kernels.gelu``): for bf16 this reproduces the
    reference bit for bit, where torch's fused ``F.gelu`` rounds once.
    Under autograd its backward is JAX's (``_GeluGrad``)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _GeluGrad.apply(x)
    return _gelu_kernel.gelu(x)


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


class _SiluGrad(torch.autograd.Function):
    """``_silu`` with the backward of JAX's VJP of ``x * logistic(x)``:
    ``g * s + (g * x) * (s * (1 - s))``, each op rounded to x's type, where
    autograd through ``_silu``'s ops would differentiate the reciprocal
    and the exponential (another bf16 rounding sequence)."""

    @staticmethod
    def forward(ctx, x):
        s = _sigmoid(x)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def _silu(x):
    """``jax.nn.silu`` as XLA lowers it: x * 1 / (1 + exp(-x)), rounded
    to x's type after every op. For bf16 this reproduces the reference
    bit for bit, where torch's fused silu differs in ~40% of elements.
    Under autograd its backward is JAX's (``_SiluGrad``)."""
    if x.requires_grad:
        return _SiluGrad.apply(x)
    return x * _sigmoid(x)


def apply_mlp(p, x, cfg: ModelConfig):
    """The MLP; under sharding rules at this rank's slice of ``d_ff``
    (column-parallel up, row-parallel down), ending in a ``psum``."""
    x = enter_split(x, "ffn", p["w_down"].shape[-2], cfg.d_ff)
    if cfg.ffn_kind == "gelu":
        h = _gelu(_einsum("bsd,df->bsf", x, p["w_up"]))
        y = _einsum("bsf,fd->bsd", h, p["w_down"])
    else:
        act = _gelu if cfg.ffn_kind == "geglu" else _silu
        g = act(torch.einsum("bsd,df->bsf", x, p["w_gate"]))
        h = g * torch.einsum("bsd,df->bsf", x, p["w_up"])
        y = torch.einsum("bsf,fd->bsd", h, p["w_down"])
    return psum_split(y, "ffn", p["w_down"].shape[-2], cfg.d_ff)
