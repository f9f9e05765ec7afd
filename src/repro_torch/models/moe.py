"""Mixture-of-Experts layer: top-k routing with two dispatch paths.

PyTorch counterpart of ``repro.models.moe``:

* ``dense``  — every expert computes every token (tiny configs, E <= 8;
  exact but E times the FLOPs).
* ``scatter`` — Switch-Transformer-style capacity dispatch: tokens are
  scattered into a per-expert [E, C, d] buffer (position = rank within
  the expert, slot-major cumsum), the experts run as one batched matmul
  and the results are gathered back weighted by the router's
  probabilities.

Padding experts (qwen2-moe: 60 -> 64) get their router logits masked so
no token routes to them. Every shape here follows from the input's shape
(the capacity too), and nothing reads a device value on the host, so a
decode step with an MoE layer stays capturable as a CUDA graph. One-hot
masks are comparisons with an ``arange`` (``F.one_hot`` checks its
input's range on the host). Where the reference adds dropped rows'
zero payloads at ``cap - 1``, the port writes them into a scratch row at
``cap`` that is cut off afterwards (the pattern of the paged pool's
scratch block); the kept rows' writes and the results are the same.

The expert-parallel dispatch over an all-to-all waits for ROADMAP A10.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

EXPERT_AXIS_PAD = 16  # pad expert count to a multiple of the model axis


def _stacked_init(gen: torch.Generator, lead, in_dim: int, out_dim: int,
                  dtype) -> torch.Tensor:
    """``[*lead, in_dim, out_dim]`` of ``layers.dense_init`` draws, one
    ``[in_dim, out_dim]`` matrix at a time into a tensor of ``dtype``: a
    full-width expert stack drawn whole in fp32 would need two fp32
    temporaries of its size (17.7 GB each for qwen2-moe's)."""
    w = torch.empty((*lead, in_dim, out_dim), dtype=dtype, device=gen.device)
    flat = w.view(-1, in_dim, out_dim)
    for i in range(flat.shape[0]):
        flat[i] = L.dense_init(gen, in_dim, out_dim, dtype)
    return w


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype, *, lead=()):
    """Router (fp32, as the reference keeps it), the routed experts
    ``[*lead, E, d, d_ff]`` / ``[*lead, E, d_ff, d]`` and the shared and
    dense-residual SwiGLU branches where the config has them."""
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "router": L.dense_init(gen, d, E, torch.float32, lead=lead),
        "w_gate": _stacked_init(gen, (*lead, E), d, f, dtype),
        "w_up": _stacked_init(gen, (*lead, E), d, f, dtype),
        "w_down": _stacked_init(gen, (*lead, E), f, d, dtype),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * f
        p["shared"] = {
            "w_gate": L.dense_init(gen, d, fs, dtype, lead=lead),
            "w_up": L.dense_init(gen, d, fs, dtype, lead=lead),
            "w_down": L.dense_init(gen, fs, d, dtype, lead=lead),
        }
    if cfg.moe_dense_residual:
        fr = cfg.dense_residual_d_ff
        p["residual"] = {
            "w_gate": L.dense_init(gen, d, fr, dtype, lead=lead),
            "w_up": L.dense_init(gen, d, fr, dtype, lead=lead),
            "w_down": L.dense_init(gen, fr, d, dtype, lead=lead),
        }
    return p


def _swiglu(x, w):
    # layers._silu: XLA's op-by-op rounding, not torch's fused silu
    h = L._silu(x @ w["w_gate"]) * (x @ w["w_up"])
    return h @ w["w_down"]


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot`` as a comparison with an ``arange``: no host
    check of the indices' range."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(p, x, cfg: ModelConfig):
    """Router: returns (weights [.., k] in x's type, idx [.., k] int64,
    aux_loss fp32 scalar)."""
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    logits = x.float() @ p["router"]
    if E > cfg.num_experts:  # mask padding experts
        pad_mask = torch.arange(E, device=x.device) >= cfg.num_experts
        logits = torch.where(pad_mask, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance auxiliary loss (fraction * mean-prob)
    k = cfg.num_experts_per_tok
    counts = _one_hot(idx, E, torch.float32).sum(-2)
    frac = counts.reshape(-1, E).mean(0)
    mean_prob = probs.reshape(-1, E).mean(0)
    aux = E * torch.sum(frac * mean_prob) / k
    return weights.to(x.dtype), idx, aux


def _moe_dense(p, x, weights, idx, cfg):
    """All-experts einsum; exact, only for tiny E."""
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    h = L._silu(torch.einsum("bsd,edf->bsef", x, p["w_gate"]))
    h = h * torch.einsum("bsd,edf->bsef", x, p["w_up"])
    out_e = torch.einsum("bsef,efd->bsed", h, p["w_down"])
    k = cfg.num_experts_per_tok
    sel = torch.zeros((*x.shape[:-1], E), dtype=x.dtype, device=x.device)
    for j in range(k):
        sel = sel + _one_hot(idx[..., j], E, x.dtype) * weights[..., j:j + 1]
    return torch.einsum("bsed,bse->bsd", out_e, sel)


def capacity(T: int, cfg: ModelConfig, capacity_factor: float = 1.25) -> int:
    """Rows per expert for ``T`` tokens: the reference's rounding (Python
    ``round``), at least 1, aligned up to 8."""
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    cap = int(max(1, round(T * cfg.num_experts_per_tok * capacity_factor / E)))
    return -(-cap // 8) * 8


def _dispatch_plan(idx_f, E, cap):
    """Slot-major ranks: for each slot j, a cumsum over the T tokens of
    the one-hot of expert ``idx_f[:, j]``, carrying the counts of slots
    < j. Returns (positions, keeps), each a list of k [T] tensors;
    dropped rows' positions are ``cap - 1``, as in the reference."""
    counts = torch.zeros((E,), dtype=torch.int64, device=idx_f.device)
    positions, keeps = [], []
    for j in range(idx_f.shape[1]):
        oh = _one_hot(idx_f[:, j], E, torch.int64)                 # [T,E]
        pos_in = torch.cumsum(oh, dim=0) - 1 + counts[None, :]     # [T,E]
        counts = counts + oh.sum(0)
        pos = pos_in.gather(1, idx_f[:, j:j + 1])[:, 0]
        keep = pos < cap
        positions.append(torch.where(keep, pos, cap - 1))
        keeps.append(keep)
    return positions, keeps


def _moe_scatter(p, x, weights, idx, cfg, capacity_factor=1.25):
    """Capacity-based dispatch (Switch impl): scatter -> batched matmul ->
    gather. The combine accumulates in fp32 and rounds to x's type once,
    as the reference does."""
    B, S, d = x.shape
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    k = cfg.num_experts_per_tok
    T = B * S
    cap = capacity(T, cfg, capacity_factor)
    xf = x.reshape(T, d)
    idx_f = idx.reshape(T, k)
    w_f = weights.reshape(T, k)
    positions, keeps = _dispatch_plan(idx_f, E, cap)

    # every kept (expert, position) is distinct; dropped rows go to the
    # scratch row ``cap``, whose duplicate writes are cut off below
    rows = torch.cat([idx_f[:, j] * (cap + 1)
                      + torch.where(keeps[j], positions[j], cap)
                      for j in range(k)])
    buf = torch.zeros((E * (cap + 1), d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, rows, xf.repeat(k, 1))
    buf = buf.view(E, cap + 1, d)[:, :cap]

    h = L._silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    y = torch.einsum("ecf,efd->ecd", h, p["w_down"])               # [E,C,d]

    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        gathered = y[idx_f[:, j], positions[j]].float()
        out = out + (torch.where(keeps[j][:, None], gathered, 0.0)
                     * w_f[:, j:j + 1].float())
    return out.reshape(B, S, d).to(x.dtype)


def apply_moe(p, x, cfg: ModelConfig, *, dispatch: str = "auto"):
    """Full MoE block: routed experts (+ shared experts, + dense
    residual). ``dispatch``: ``"auto"`` (dense for <= 8 experts, else
    scatter), ``"dense"`` or ``"scatter"``. Returns (out, aux_loss)."""
    weights, idx, aux = route(p, x, cfg)
    if dispatch == "auto":
        dispatch = "dense" if cfg.num_experts <= 8 else "scatter"
    if dispatch == "dense":
        out = _moe_dense(p, x, weights, idx, cfg)
    elif dispatch == "expert_parallel":
        raise NotImplementedError(
            "dispatch='expert_parallel' (the all-to-all expert-parallel "
            "MoE) is not ported yet (ROADMAP A10)")
    elif dispatch == "scatter":
        out = _moe_scatter(p, x, weights, idx, cfg)
    else:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    if "shared" in p:
        out = out + _swiglu(x, p["shared"])
    if "residual" in p:
        out = out + _swiglu(x, p["residual"])
    return out, aux
