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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _silu, dense_init


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
         else x.new_zeros((b, H, P, N), dtype=torch.float32))
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


def _gated_rmsnorm(y, z, scale, eps=1e-5):
    yf = (y * _silu(z)).float()
    out = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
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


def _project(p, x):
    """Per-part projections. x [B,S,d] -> (z, xs, Bm, Cm, dt_raw)."""
    return tuple(torch.einsum("bsd,dk->bsk", x, p[name])
                 for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def apply_mamba2(p, x, cfg: ModelConfig, *, state=None, ssd_fn=None):
    """Full Mamba2 mixer over a sequence (train/prefill).

    x: [B,S,d]. state: None or {"conv_x","conv_B","conv_C", "ssd"}.
    ``ssd_fn`` is the scan, with ``ssd_chunked``'s signature (default:
    ``ssd_chunked``; ``kernels.ops.ssd`` runs the SSD kernel).
    Returns (out [B,S,d], new_state).
    """
    B_, S, _ = x.shape
    di = cfg.ssm_d_inner
    nh, g, N, P = cfg.ssm_heads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_head_dim
    z, xh, Bh, Ch, dt = _project(p, x)
    st = state or {}
    xh, ncx = _causal_conv(xh, p["conv_x_w"], p["conv_x_b"], st.get("conv_x"))
    Bh, ncB = _causal_conv(Bh, p["conv_B_w"], p["conv_B_b"], st.get("conv_B"))
    Ch, ncC = _causal_conv(Ch, p["conv_C_w"], p["conv_C_b"], st.get("conv_C"))
    xs = xh.reshape(B_, S, nh, P)
    Bm = Bh.reshape(B_, S, g, N)
    Cm = Ch.reshape(B_, S, g, N)
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    fn = ssd_fn or ssd_chunked
    y, final_state = fn(xs, dt, A, Bm, Cm, cfg.ssm_chunk, st.get("ssd"))
    y = y + p["D"][None, None, :, None].to(y.dtype) * xs
    y = y.reshape(B_, S, di)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    return out, {"conv_x": ncx, "conv_B": ncB, "conv_C": ncC,
                 "ssd": final_state}


def apply_mamba2_decode(p, x, cfg: ModelConfig, *, state):
    """Single-token decode: x [B,1,d] with state dict. O(1) in history."""
    B_ = x.shape[0]
    di = cfg.ssm_d_inner
    nh, g, N, P = cfg.ssm_heads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_head_dim
    z, xh, Bh, Ch, dt = _project(p, x)
    xh, ncx = _causal_conv(xh, p["conv_x_w"], p["conv_x_b"], state["conv_x"])
    Bh, ncB = _causal_conv(Bh, p["conv_B_w"], p["conv_B_b"], state["conv_B"])
    Ch, ncC = _causal_conv(Ch, p["conv_C_w"], p["conv_C_b"], state["conv_C"])
    xs = xh[:, 0].reshape(B_, nh, P)
    Bm = Bh[:, 0].reshape(B_, g, N)
    Cm = Ch[:, 0].reshape(B_, g, N)
    dt1 = _softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, new_ssd = ssd_decode_step(xs, dt1, A, Bm, Cm, state["ssd"])
    y = y + p["D"][None, :, None].to(y.dtype) * xs
    y = y.reshape(B_, 1, di)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    return out, {"conv_x": ncx, "conv_B": ncB, "conv_C": ncC, "ssd": new_ssd}
