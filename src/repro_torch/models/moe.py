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

Under sharding rules (``parallel.sharding.use_rules``) the dense and
scatter dispatches run this rank's experts and ``d_ff`` slice over the
whole (gathered) token set and sum across the ranks; the
expert-parallel dispatch (``_moe_expert_parallel``) sends each token to
the rank that owns its expert over two all-to-alls, with the
reference's capacities and drop rule.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as SH

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


def _acc(dtype) -> torch.dtype:
    """The routing and combine type: fp32, or ``dtype`` where it is
    wider (a float64 forward, as a finite-difference check runs)."""
    return torch.promote_types(dtype, torch.float32)


def route(p, x, cfg: ModelConfig):
    """Router: returns (weights [.., k] in x's type, idx [.., k] int64,
    aux_loss fp32 scalar)."""
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    logits = x.to(_acc(x.dtype)) @ p["router"]
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


def _moe_dense(p, x, weights, idx, cfg, e0: int = 0):
    """All-experts einsum; exact, only for tiny E. Under expert sharding
    ``p`` holds the experts ``e0 ..`` of this rank, and the result is
    their part of the sum (in x's type)."""
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    h = L._silu(torch.einsum("bsd,edf->bsef", x, p["w_gate"]))
    h = h * torch.einsum("bsd,edf->bsef", x, p["w_up"])
    out_e = torch.einsum("bsef,efd->bsed", h, p["w_down"])
    k = cfg.num_experts_per_tok
    sel = torch.zeros((*x.shape[:-1], E), dtype=x.dtype, device=x.device)
    for j in range(k):
        sel = sel + _one_hot(idx[..., j], E, x.dtype) * weights[..., j:j + 1]
    return torch.einsum("bsed,bse->bsd", out_e,
                        sel[..., e0:e0 + out_e.shape[-2]])


def capacity(T: int, cfg: ModelConfig, capacity_factor: float = 1.25) -> int:
    """Rows per expert for ``T`` tokens: the reference's rounding (Python
    ``round``), at least 1, aligned up to 8."""
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    cap = int(max(1, round(T * cfg.num_experts_per_tok * capacity_factor / E)))
    return -(-cap // 8) * 8


def _dispatch_plan(idx_f, E, cap, drop_at=None):
    """Slot-major ranks: for each slot j, a cumsum over the T tokens of
    the one-hot of bucket ``idx_f[:, j]`` (of E), carrying the counts of
    slots < j. Returns (positions, keeps), each a list of k [T] tensors;
    dropped rows' positions are ``drop_at`` (default ``cap - 1``, as in
    the reference's scatter)."""
    drop_at = cap - 1 if drop_at is None else drop_at
    counts = torch.zeros((E,), dtype=torch.int64, device=idx_f.device)
    positions, keeps = [], []
    for j in range(idx_f.shape[1]):
        oh = _one_hot(idx_f[:, j], E, torch.int64)                 # [T,E]
        pos_in = torch.cumsum(oh, dim=0) - 1 + counts[None, :]     # [T,E]
        counts = counts + oh.sum(0)
        pos = pos_in.gather(1, idx_f[:, j:j + 1])[:, 0]
        keep = pos < cap
        positions.append(torch.where(keep, pos, drop_at))
        keeps.append(keep)
    return positions, keeps


def _experts(buf, p):
    """The SwiGLU experts over per-expert buffers [E, C, d]."""
    h = L._silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


def _scatter_sum(p, x, weights, idx, cfg, capacity_factor=1.25, e0=0):
    """The scatter dispatch's weighted sum [T, d] in fp32, over the
    experts ``p`` holds (``e0 ..``; all of them unsharded). The capacity
    and every slot's position are the whole dispatch's."""
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
    E_loc = p["w_gate"].shape[-3]
    y = _experts(buf.view(E, cap + 1, d)[e0:e0 + E_loc, :cap], p)  # [E,C,d]

    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        e = idx_f[:, j] - e0
        keep = keeps[j]
        if E_loc < E:
            keep = keep & (e >= 0) & (e < E_loc)
            e = e.clamp(0, E_loc - 1)
        gathered = y[e, positions[j]].float()
        out = out + (torch.where(keep[:, None], gathered, 0.0)
                     * w_f[:, j:j + 1].float())
    return out


def _moe_scatter(p, x, weights, idx, cfg, capacity_factor=1.25):
    """Capacity-based dispatch (Switch impl): scatter -> batched matmul ->
    gather. The combine accumulates in fp32 and rounds to x's type once,
    as the reference does."""
    out = _scatter_sum(p, x, weights, idx, cfg, capacity_factor)
    return out.reshape(x.shape).to(x.dtype)


def _swiglu_split(x, w, d_ff: int):
    """``_swiglu`` at this rank's slice of the branch's ``d_ff``, summed
    across the ``ffn`` axis where it is split."""
    n = w["w_down"].shape[-2]
    y = _swiglu(L.enter_split(x, "ffn", n, d_ff), w)
    return L.psum_split(y, "ffn", n, d_ff)


def _batch_axes(rules):
    b = rules.get("batch")
    return () if b is None else (tuple(b) if isinstance(b, tuple) else (b,))


def _routed_split(p, x, cfg, dispatch, rules):
    """The dense or scatter dispatch under sharding rules: this rank's
    experts (and its ``d_ff`` slice of them) over the full token set,
    then a ``psum``. Routing is replicated: the batch's rows are gathered
    over the batch axes first (minor axis first, the row-major split),
    so capacities, slots and the load-balance loss are the whole
    dispatch's, as in the reference; this rank keeps its rows of the
    sum. Returns (out, aux).

    Gradients (``parallel.mesh``'s convention): over a batch axis the
    ranks' cotangents of the gathered rows differ (each keeps its own
    rows of the sum), so the sum over it takes a psum backward and the
    gather a reduce-scatter; over any other axis that splits the experts
    (or their ``d_ff``), the replicated rows and gate weights enter the
    split and the sum passes its cotangent through."""
    mesh = L.rule_mesh(rules)
    batch = _batch_axes(rules)
    x_all = x
    for a in reversed(batch):
        x_all = mesh.all_gather(x_all, a, dim=0, grad="reduce_scatter")
    weights, idx, aux = route(p, x_all, cfg)
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    E_loc = p["w_gate"].shape[-3]
    e_axis = L.split_axis("experts", E_loc, E)
    e0 = mesh.axes_index(e_axis) * E_loc if e_axis else 0
    f_axis = L.split_axis("ffn", p["w_down"].shape[-2], cfg.d_ff)
    split = tuple(dict.fromkeys(a for a in (e_axis, f_axis) if a))
    x_in = x_all
    for a in split:
        if a not in batch:
            x_in, weights = mesh.enter(x_in, a), mesh.enter(weights, a)
    if dispatch == "dense":
        out = _moe_dense(p, x_in, weights, idx, cfg, e0)
    else:
        out = _scatter_sum(p, x_in, weights, idx, cfg, e0=e0)
    for a in split:
        out = mesh.psum(out, a, grad="psum" if a in batch else "identity")
    out = out.reshape(x_all.shape).to(x.dtype)
    if x_all is not x:
        i = mesh.axes_index(batch) * x.shape[0]
        out = out[i:i + x.shape[0]]
    return out, aux


def apply_moe(p, x, cfg: ModelConfig, *, dispatch: str = "auto"):
    """Full MoE block: routed experts (+ shared experts, + dense
    residual). ``dispatch``: ``"auto"`` (under sharding rules with
    ``rules["moe_a2a"]`` and experts split, the expert-parallel dispatch
    for more than 8 experts; otherwise dense for <= 8 experts, else
    scatter), ``"dense"``, ``"scatter"`` or ``"expert_parallel"``
    (``_moe_expert_parallel``; outside sharding rules it raises, as no
    mesh is there to run it on). Under sharding
    rules the dense and scatter dispatches run this rank's experts over
    every token (``_routed_split``), and the shared and residual branches
    their ``d_ff`` slice, each ending in a ``psum``.
    Returns (out, aux_loss)."""
    rules = SH.current_rules()
    if dispatch == "auto":
        if (rules and rules.get("moe_a2a") and rules.get("experts")
                and cfg.num_experts > 8):
            dispatch = "expert_parallel"
        else:
            dispatch = "dense" if cfg.num_experts <= 8 else "scatter"
    if dispatch not in ("dense", "scatter", "expert_parallel"):
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    if dispatch == "expert_parallel":
        if rules is None:
            raise NotImplementedError(
                "dispatch='expert_parallel' runs across the ranks of a "
                "mesh, under sharding rules (parallel.sharding.use_rules); "
                "a single process's step (the engine's) has none: an "
                "engine that spans ranks is not ported (ROADMAP A10)")
        weights, idx, aux = route(p, x, cfg)
        out = _moe_expert_parallel(p, x, weights, idx, cfg, rules)
    elif rules is not None:
        out, aux = _routed_split(p, x, cfg, dispatch, rules)
    else:
        weights, idx, aux = route(p, x, cfg)
        if dispatch == "dense":
            out = _moe_dense(p, x, weights, idx, cfg)
        else:
            out = _moe_scatter(p, x, weights, idx, cfg)
    if "shared" in p:
        out = out + _swiglu_split(x, p["shared"],
                                  cfg.num_shared_experts * cfg.d_ff)
    if "residual" in p:
        out = out + _swiglu_split(x, p["residual"], cfg.dense_residual_d_ff)
    return out, aux


# ===================================================================== a2a EP
def _moe_expert_parallel(p, x, weights, idx, cfg: ModelConfig, rules,
                         capacity_factor: float = 1.3):
    """Expert-parallel MoE over an explicit all-to-all, the reference's
    ``shard_map`` program run by this rank: x [Bl, S, d] is this rank's
    rows (the batch split over the ``experts`` axis), ``p`` its experts
    (``E / n`` of them) and its ``d_ff`` slice under ``rules["ffn"]``.

    Each (token, slot) goes to the rank that owns its expert, into a
    bucket of ``cap`` slots (slot-major ranks, as the reference; a slot
    past ``cap`` is dropped); the owner scatters what it receives into
    ``cap_e`` rows per local expert (a row past ``cap_e`` is dropped),
    runs its experts, sums the ``d_ff`` slices over ``ffn``, and sends
    the outputs back, where they are combined with the router's weights
    in fp32 (``_acc``: float64 for a float64 forward). Two all-to-alls:
    the tokens, their local expert ids and gate weights travel together
    in one buffer of that type (ids below 2**24 and bf16 widen exactly),
    and the outputs come back in x's type. Under autograd each
    all-to-all's backward is the same all-to-all of the cotangent, and
    the received tokens enter the ``ffn`` split. The slots dropped on
    this rank (at its send buckets and at its experts) are added to
    ``rules["mesh"].moe_dropped`` as a device scalar (no host sync).
    Returns [Bl, S, d] in x's type."""
    mesh = L.rule_mesh(rules)
    exp_axis = rules.get("experts")
    n_dest = mesh.axis_size(exp_axis)
    E = cfg.padded_experts(EXPERT_AXIS_PAD)
    E_loc = E // n_dest
    if p["w_gate"].shape[-3] != E_loc:
        raise ValueError(f"expert-parallel dispatch: {p['w_gate'].shape[-3]} "
                         f"experts held, {E_loc} expected on {exp_axis!r}")
    k = cfg.num_experts_per_tok
    Bl, S, d = x.shape
    T = Bl * S
    # slots a rank sends each destination, rows each local expert takes
    cap = int(max(8, round(T * k * capacity_factor / n_dest)))
    cap = -(-cap // 8) * 8
    cap_e = int(max(8, round(n_dest * cap * 1.3 / E_loc)))
    cap_e = -(-cap_e // 8) * 8
    acc = _acc(x.dtype)
    xf = x.reshape(T, d)
    w_f = weights.reshape(T, k).to(acc)
    idx_f = idx.reshape(T, k)
    dest = idx_f // E_loc                      # [T,k] destination rank
    e_loc = idx_f % E_loc                      # local expert id there
    poss, keeps = _dispatch_plan(dest, n_dest, cap, drop_at=cap)
    # send buffer [n_dest, cap + 1, d + 2]: the token, its local expert
    # id and its gate weight; row ``cap`` takes the dropped slots
    send = torch.zeros((n_dest, cap + 1, d + 2), dtype=acc, device=x.device)
    for j in range(k):
        row = torch.cat([torch.where(keeps[j][:, None], xf, 0).to(acc),
                         e_loc[:, j:j + 1].to(acc),
                         torch.where(keeps[j], w_f[:, j], 0.0)[:, None]], 1)
        send[dest[:, j], poss[j]] = row
    recv = mesh.all_to_all(send[:, :cap].contiguous(), exp_axis)
    Tr = n_dest * cap
    rxf = recv[..., :d].reshape(Tr, d).to(x.dtype)
    if rules.get("ffn"):     # the tokens enter this rank's d_ff slice
        rxf = mesh.enter(rxf, rules["ffn"])
    ref_ = recv[..., d].reshape(Tr).long()
    rgf = recv[..., d + 1].reshape(Tr)
    valid = rgf > 0                            # unfilled slots are junk
    oh = _one_hot(ref_, E_loc, torch.int64) * valid[:, None]
    pe = (torch.cumsum(oh, 0) - 1).gather(1, ref_[:, None])[:, 0]
    keep_e = (pe < cap_e) & valid
    pe = torch.where(keep_e, pe, cap_e)
    buf = torch.zeros((E_loc, cap_e + 1, d), dtype=x.dtype, device=x.device)
    buf[ref_, pe] = torch.where(keep_e[:, None], rxf, 0)
    yb = _experts(buf[:, :cap_e], p)           # partial over ffn shard
    y_tok = yb[ref_, pe.clamp(max=cap_e - 1)]
    y_tok = torch.where(keep_e[:, None], y_tok, 0)
    if rules.get("ffn"):
        y_tok = mesh.psum(y_tok, rules["ffn"])
    ry = mesh.all_to_all(y_tok.to(x.dtype).reshape(n_dest, cap, d),
                         exp_axis)             # back at the source rank
    out = torch.zeros((T, d), dtype=acc, device=x.device)
    for j in range(k):
        got = ry[dest[:, j], poss[j].clamp(max=cap - 1)]
        got = torch.where(keeps[j][:, None], got, 0)
        out = out + got.to(acc) * w_f[:, j:j + 1]
    dropped = sum((~kp).sum() for kp in keeps) + (valid & ~keep_e).sum()
    mesh.moe_dropped = mesh.moe_dropped + dropped
    return out.reshape(Bl, S, d).to(x.dtype)
