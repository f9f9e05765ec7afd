"""Mamba2 (SSD — state-space duality) mixer.

PyTorch counterpart of ``repro.models.ssm``. Tokens are split into chunks
of length Q; within a chunk the dual quadratic (attention-like) form is
used, across chunks a recurrent state h [B, H, P, N] is carried. B/C
projections are per-*group* (ngroups, shared across heads — the MQA
analogue). The projections and depthwise convs are per part (z, x, B, C,
dt) as in the reference; parameters are a dict with the reference's keys.

``ssd_chunked`` is the plain chunked scan the SSD kernel
(``kernels/ssd_scan.py``) is checked against; ``apply_mamba2`` calls
through an injectable ``ssd_fn`` (``kernels.ops.ssd`` runs the kernel).

Under sharding rules (``parallel.sharding.use_rules``) a mixer runs at
this rank's heads of the reference's head-aligned split (``ssm_heads``:
``w_z``, ``w_x``, ``w_dt``, the x conv, ``norm_scale`` and the rows of
``out_proj``), read from ``w_dt``'s shape (``SSMHeads``). ``B`` and
``C`` stay whole: every rank computes them and takes the groups its heads
read. The gated norm's mean over ``d_inner`` becomes a cross-rank sum of
squares, and the row-parallel ``out_proj`` ends in a ``psum``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import _silu, dense_init
from repro_torch.parallel import sharding as SH


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, dtype):
    d = cfg.d_model
    di = cfg.ssm_d_inner
    nh, g, N = cfg.ssm_heads, cfg.ssm_ngroups, cfg.ssm_state
    K = cfg.ssm_conv_dim
    dev = gen.device

    def conv(ch):
        w = torch.randn((K, ch), generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * 0.1).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    conv_x = conv(di)
    conv_B = conv(g * N)
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=dev)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "w_z": dense_init(gen, d, di, dtype),
        "w_x": dense_init(gen, d, di, dtype),
        "w_B": dense_init(gen, d, g * N, dtype),
        "w_C": dense_init(gen, d, g * N, dtype),
        "w_dt": dense_init(gen, d, nh, dtype),
        "conv_x_w": conv_x,
        "conv_B_w": conv_B,
        "conv_C_w": conv_B.clone(),   # the reference draws both from one key
        "conv_x_b": zeros(di),
        "conv_B_b": zeros(g * N),
        "conv_C_b": zeros(g * N),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def segsum(dA):
    """Stable segment-sum: out[..., i, j] = sum_{j<k<=i} dA[..., k] (i >= j)."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return torch.where(mask, out, float("-inf"))


def pad_time(t, pad: int):
    """Zero-pad dim 1 (time, or the sequence) of a [B, S, ...] tensor at
    the end, as the reference's ``jnp.pad`` calls do."""
    if not pad:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan (plain PyTorch).

    x: [b, L, H, P]; dt: [b, L, H] (already softplus'd); A: [H] (negative);
    B, C: [b, L, G, N]. Returns (y [b, L, H, P], final_state [b, H, P, N]).
    """
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L
    x, dt, B, C = (pad_time(t, pad) for t in (x, dt, B, C))

    xc = x.reshape(b, nc, Q, H, P).float()
    dtc = dt.reshape(b, nc, Q, H).float()
    Bc = B.reshape(b, nc, Q, G, N).float()
    Cc = C.reshape(b, nc, Q, G, N).float()
    dA = dtc * A[None, None, None, :]                       # [b,nc,Q,H]
    dA_cs = torch.cumsum(dA, dim=2)                         # [b,nc,Q,H]

    # ---- intra-chunk (diagonal blocks): attention-like quadratic form
    Lmat = torch.exp(segsum(dA.permute(0, 1, 3, 2)))        # [b,nc,H,Q,Q]
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    CB = torch.repeat_interleave(CB, rep, dim=2)            # [b,nc,H,Q,Q]
    scores = CB * Lmat * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores, xc)

    # ---- chunk states: contribution of each chunk to the carried state
    decay = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)          # [b,nc,Q,H]
    Bh = torch.repeat_interleave(Bc, rep, dim=3)            # [b,nc,Q,H,N]
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn",
                          decay * dtc, Bh, xc)              # [b,nc,H,P,N]

    # ---- inter-chunk recurrence
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])             # [b,nc,H]
    h = (initial_state.float() if initial_state is not None
         else xc.new_zeros((b, H, P, N)))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                    # state BEFORE chunk
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                     # [b,nc,H,P,N]

    # ---- state -> output within each chunk
    Ch = torch.repeat_interleave(Cc, rep, dim=3)            # [b,nc,Q,H,N]
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, h_prev,
                         torch.exp(dA_cs))
    y = (y_diag + y_off).reshape(b, nc * Q, H, P)[:, :L]
    return y.to(x.dtype), h.to(x.dtype)


def ssd_decode_step(x, dt, A, B, C, state):
    """Single-token recurrence: x [b,H,P], dt [b,H], B/C [b,G,N],
    state [b,H,P,N] -> (y [b,H,P], new_state)."""
    G = B.shape[1]
    H = x.shape[1]
    rep = H // G
    Bh = torch.repeat_interleave(B.float(), rep, dim=1)     # [b,H,N]
    Ch = torch.repeat_interleave(C.float(), rep, dim=1)
    dtf = dt.float()
    dA = torch.exp(dtf * A[None, :])                        # [b,H]
    new_state = (state.float() * dA[:, :, None, None]
                 + torch.einsum("bh,bhn,bhp->bhpn", dtf, Bh, x.float()))
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state.to(state.dtype)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no linear switch
    (``F.softplus`` turns linear above a threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gated_rmsnorm(y, z, scale, heads, eps=1e-5):
    """RMS norm of ``y * silu(z)`` over the whole ``d_inner``, of which
    ``heads`` (``SSMHeads``) holds this rank's part."""
    yf = (y * _silu(z)).float()
    out = yf * torch.rsqrt(heads.mean_square(yf) + eps)
    return (out * scale.float()).to(y.dtype)


def _causal_conv(xpart, w, b, conv_state=None):
    """Depthwise causal conv over time. xpart [B,S,Ch]; w [K,Ch].

    conv_state [B,K-1,Ch] (history) or None. Returns (out, new_state)."""
    K = w.shape[0]
    if conv_state is None:
        hist = xpart.new_zeros((xpart.shape[0], K - 1, xpart.shape[2]))
    else:
        hist = conv_state
    full = torch.cat([hist, xpart], dim=1)
    out = torch.zeros(xpart.shape, dtype=torch.float32, device=xpart.device)
    S = xpart.shape[1]
    for i in range(K):  # K is tiny (4): unrolled taps
        out = out + full[:, i:i + S].float() * w[i].float()
    out = _silu(out + b.float()).to(xpart.dtype)
    new_state = full[:, full.shape[1] - (K - 1):]
    return out, new_state


class SSMHeads:
    """This rank's Mamba2 heads under the sharding rules installed:
    ``n`` local heads, read from ``w_dt``'s shape; ``axis``, the mesh
    axis they are split over (None when this rank holds every head);
    ``h0``, the first global head it holds; ``groups``, the B/C groups
    its heads read (head h reads group ``h // (H // G)``): a slice where
    they form whole groups or share one, else an index of each head's
    group. Every replicated tensor that enters the split (``x`` of the
    split projections, the whole ``B`` / ``C``, the per-head leaves
    ``dt_bias``, ``A_log`` and ``D``) goes through ``RankMesh.enter``,
    whose backward sums its cotangent over ``axis``
    (``parallel.mesh``'s convention)."""

    def __init__(self, cfg: ModelConfig, n: int):
        H, G = cfg.ssm_heads, cfg.ssm_ngroups
        self.n, self.h0, self.groups, self.mesh = n, 0, None, None
        self.d_inner = cfg.ssm_d_inner
        self.axis = L.split_axis("ssm_heads", n, H)
        if self.axis is None:
            return
        self.mesh = L.rule_mesh(SH.current_rules())
        self.h0 = self.mesh.axes_index(self.axis) * n
        R = H // G
        lo, hi = self.h0 // R, (self.h0 + n - 1) // R + 1
        if hi - lo == 1 or (self.h0 % R == 0 and n % R == 0):
            self.groups = slice(lo, hi)
        else:
            self.groups = torch.arange(self.h0, self.h0 + n) // R

    def enter(self, t):
        return t if self.axis is None else self.mesh.enter(t, self.axis)

    def local(self, t):
        """A whole per-head leaf [H] at this rank's heads."""
        if self.axis is None:
            return t
        return self.enter(t).narrow(-1, self.h0, self.n)

    def select(self, t):
        """Whole B or C [..., G, N] at the groups this rank's heads read,
        contiguous (the SSD kernel takes contiguous operands)."""
        if self.axis is None:
            return t
        g = self.groups
        t = self.enter(t)[..., g.to(t.device) if torch.is_tensor(g) else g,
                          :]
        return t.contiguous()

    def mean_square(self, yf):
        """The mean of ``yf``'s squares over the whole ``d_inner``; split,
        this rank's float32 sum of squares summed over ``axis``, over the
        global ``d_inner``. The rms is replicated and consumed by split
        elements, so each rank's cotangent of it is a partial sum: the
        psum's backward sums them (``grad="psum"``)."""
        if self.axis is None:
            return yf.square().mean(-1, keepdim=True)
        ss = yf.square().sum(-1, keepdim=True)
        return self.mesh.psum(ss, self.axis, grad="psum") / self.d_inner

    def reduce(self, y):
        """The row-parallel ``out_proj``'s partial sums over ``axis``."""
        return y if self.axis is None else self.mesh.psum(y, self.axis)


def _project(p, x, heads):
    """Per-part projections. x [B,S,d] -> (z, xs, Bm, Cm, dt_raw): x
    enters the split projections; B and C are computed whole."""
    xs = heads.enter(x)

    def proj(t, name):
        return torch.einsum("bsd,dk->bsk", t, p[name])

    return (proj(xs, "w_z"), proj(xs, "w_x"), proj(x, "w_B"), proj(x, "w_C"),
            proj(xs, "w_dt"))


def apply_mamba2(p, x, cfg: ModelConfig, *, state=None, ssd_fn=None):
    """Full Mamba2 mixer over a sequence (train/prefill).

    x: [B,S,d]. state: None or {"conv_x","conv_B","conv_C", "ssd"}.
    ``ssd_fn`` is the scan, with ``ssd_chunked``'s signature (default:
    ``ssd_chunked``; ``kernels.ops.ssd`` runs the SSD kernel).
    Under sharding rules it runs at this rank's heads (``SSMHeads``).
    Returns (out [B,S,d], new_state).
    """
    B_, S, _ = x.shape
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    heads = SSMHeads(cfg, p["w_dt"].shape[-1])
    z, xh, Bh, Ch, dt = _project(p, x, heads)
    st = state or {}
    xh, ncx = _causal_conv(xh, p["conv_x_w"], p["conv_x_b"], st.get("conv_x"))
    Bh, ncB = _causal_conv(Bh, p["conv_B_w"], p["conv_B_b"], st.get("conv_B"))
    Ch, ncC = _causal_conv(Ch, p["conv_C_w"], p["conv_C_b"], st.get("conv_C"))
    xs = xh.reshape(B_, S, heads.n, P)
    Bm = heads.select(Bh.reshape(B_, S, cfg.ssm_ngroups, N))
    Cm = heads.select(Ch.reshape(B_, S, cfg.ssm_ngroups, N))
    dt = _softplus(dt.float() + heads.local(p["dt_bias"]))
    A = -torch.exp(heads.local(p["A_log"]))
    fn = ssd_fn or ssd_chunked
    y, final_state = fn(xs, dt, A, Bm, Cm, cfg.ssm_chunk, st.get("ssd"))
    y = y + heads.local(p["D"])[None, None, :, None].to(y.dtype) * xs
    y = y.reshape(B_, S, heads.n * P)
    y = _gated_rmsnorm(y, z, p["norm_scale"], heads)
    out = heads.reduce(torch.einsum("bsk,kd->bsd", y, p["out_proj"]))
    return out, {"conv_x": ncx, "conv_B": ncB, "conv_C": ncC,
                 "ssd": final_state}


def apply_mamba2_decode(p, x, cfg: ModelConfig, *, state):
    """Single-token decode: x [B,1,d] with state dict. O(1) in history.
    Under sharding rules it runs at this rank's heads (``SSMHeads``)."""
    B_ = x.shape[0]
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    heads = SSMHeads(cfg, p["w_dt"].shape[-1])
    z, xh, Bh, Ch, dt = _project(p, x, heads)
    xh, ncx = _causal_conv(xh, p["conv_x_w"], p["conv_x_b"], state["conv_x"])
    Bh, ncB = _causal_conv(Bh, p["conv_B_w"], p["conv_B_b"], state["conv_B"])
    Ch, ncC = _causal_conv(Ch, p["conv_C_w"], p["conv_C_b"], state["conv_C"])
    xs = xh[:, 0].reshape(B_, heads.n, P)
    Bm = heads.select(Bh[:, 0].reshape(B_, cfg.ssm_ngroups, N))
    Cm = heads.select(Ch[:, 0].reshape(B_, cfg.ssm_ngroups, N))
    dt1 = _softplus(dt[:, 0].float() + heads.local(p["dt_bias"]))
    A = -torch.exp(heads.local(p["A_log"]))
    y, new_ssd = ssd_decode_step(xs, dt1, A, Bm, Cm, state["ssd"])
    y = y + heads.local(p["D"])[None, :, None].to(y.dtype) * xs
    y = y.reshape(B_, 1, heads.n * P)
    y = _gated_rmsnorm(y, z, p["norm_scale"], heads)
    out = heads.reduce(torch.einsum("bsk,kd->bsd", y, p["out_proj"]))
    return out, {"conv_x": ncx, "conv_B": ncB, "conv_C": ncC, "ssd": new_ssd}
