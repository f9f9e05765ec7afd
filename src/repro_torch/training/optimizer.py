"""AdamW with decoupled weight decay and a warmup-cosine schedule, over the
port's nested-dict tensor trees.

PyTorch counterpart of ``repro.training.optimizer``: bias-corrected
moments, decoupled decay, global-norm clipping and the warmup-cosine
learning rate, in float32 and in the reference's order of operations.
Trees are flattened as JAX flattens a dict (keys sorted at every level,
``tree_items``), so sums over leaves run in the reference's order.

``apply_updates`` updates the parameters and the moments IN PLACE under
``torch.no_grad()`` (the reference returns new trees) and returns them,
so a step holds one copy of each. Three of the reference's quirks are
kept on purpose:

* ``_decay_mask`` decays every leaf with ``ndim >= 2``, the stacked norm
  scales ``[L, d]`` too;
* ``lr_at`` computes in float32, so at the end of the warmup it returns
  float32's ``1e-3``, ``1.0000000474974513e-3``, above ``cfg.lr``;
* bf16 moments (``init_opt_state(moments_dtype="bfloat16")``) come out
  of a step in float32: the reference's ``b1 * m + (1 - b1) * g`` adds a
  bf16 and a float32 array. Such a leaf of the state is replaced by a
  float32 tensor, not written in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import spec_axes


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


# ------------------------------------------------------------------ trees
def tree_items(tree, prefix=()):
    """``(path, leaf)`` of a nested dict, keys sorted at every level: the
    order of ``jax.tree_util.tree_flatten_with_path`` on the same dict."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_items(v, (*prefix, k)))
        else:
            out.append(((*prefix, k), v))
    return out


def tree_leaves(tree):
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same paths of
    ``rest``), keeping the nested-dict structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tree_from(paths, values):
    """The nested dict holding ``values`` at ``paths`` (``tree_items``'s
    inverse)."""
    out = {}
    for path, v in zip(paths, values):
        tree_set(out, path, v)
    return out


# --------------------------------------------------------------- schedule
def _f32(value, device):
    return torch.full((), value, dtype=torch.float32, device=device)


def _reciprocal(n: int) -> np.float32:
    """float32's ``1 / n``: XLA compiles a division by a constant into a
    multiplication by its float32 reciprocal (folded into a constant
    factor beside it), and so does ``lr_at``."""
    return np.float32(1) / np.float32(n)


_H = float.fromhex
#: glibc's ``__sincosf_table[0]``: 2/pi scaled by 2^24, pi/2, and the
#: cosine (c0..c4) and sine (s1..s3) polynomials on [-pi/4, pi/4]
_HPI_INV, _HPI = _H("0x1.45f306dc9c883p+23"), _H("0x1.921fb54442d18p0")
_C = (1.0, _H("-0x1.ffffffd0c621cp-2"), _H("0x1.55553e1068f19p-5"),
      _H("-0x1.6c087e89a359dp-10"), _H("0x1.99343027bf8c3p-16"))
_S = (_H("-0x1.555545995a603p-3"), _H("0x1.1107605230bc4p-7"),
      _H("-0x1.994eb3774cf24p-13"))


def _xla_cos(y):
    """XLA's CPU float32 ``cos``, which is glibc's ``cosf``: the argument
    in float64, reduced by its nearest multiple n of pi/2, then the
    cosine polynomial (negated for n = 2, 3 mod 4) or the sine polynomial
    of the signed remainder, rounded to float32. For |y| < 120 (lr_at's
    argument lies in [0, pi]) it is bit-equal to ``jnp.cos``; torch's
    ``cos`` is an ulp away at ~5% of lr_at's steps, and ``1 + cos`` near
    pi makes that several ulps of the rate."""
    x = y.double()
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    small = x.abs() < float(np.float32(math.pi / 4))
    n = torch.where(small, 0, n)
    r = torch.where(small, x, x - n.double() * _HPI)
    r2 = r * r
    r4 = r2 * r2
    cos = ((_C[0] + r2 * _C[1]) + r4 * _C[2]) \
        + (r4 * r2) * (_C[3] + r2 * _C[4])
    cos = torch.where((n & 2) != 0, -cos, cos)
    rs = torch.where((n & 3) == 1, -r, r)
    r3 = rs * r2
    sin = (rs + r3 * _S[0]) + (r3 * r2) * (_S[1] + r2 * _S[2])
    out = torch.where((n & 1) == 0, cos, sin)
    return torch.where(x.abs() < _H("0x1p-12"), 1.0, out).float()


def lr_at(cfg: OptimizerConfig, step):
    """The learning rate at ``step`` (an int or a tensor of steps) in
    float32 on the step's device: linear warmup, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``, as the reference's compiled
    step computes it on the CPU: each division by a constant is a
    multiplication by its float32 reciprocal (the reference's eager
    ``lr_at`` divides, up to 7 ulps away), the cosine is XLA's
    (``_xla_cos``) and its scale and shift one fused multiply-add."""
    f32 = np.float32
    step = torch.as_tensor(step).to(torch.float32)
    warm = step * float(f32(cfg.lr) * _reciprocal(max(cfg.warmup_steps, 1)))
    t = torch.clip((step - cfg.warmup_steps)
                   * float(_reciprocal(max(cfg.total_steps - cfg.warmup_steps,
                                           1))),
                   0.0, 1.0)
    # min_lr_ratio + (1 - min_lr_ratio) * 0.5 * (1 + cos), the product and
    # the sum fused as XLA fuses them (one rounding, from float64)
    scaled = (1 + _xla_cos(math.pi * t)).double() * float(
        f32((1 - cfg.min_lr_ratio) * 0.5))
    cos = (scaled + float(f32(cfg.min_lr_ratio))).float()
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


# ------------------------------------------------------------------ AdamW
def init_opt_state(params, moments_dtype="float32"):
    """``step`` (int32, 0-d) and zero moments ``mu`` / ``nu`` shaped like
    ``params``, on its device. ``moments_dtype="bfloat16"`` halves the
    state until the first step (see the module docstring)."""
    dt = (getattr(torch, moments_dtype) if isinstance(moments_dtype, str)
          else moments_dtype)
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


def _decay_mask(params):
    """True where weight decay applies (2D+ leaves, as the reference)."""
    return tree_map(lambda p: p.ndim >= 2, params)


def global_norm(tree, specs=None, mesh=None):
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in the reference's order. On one rank of a mesh (``specs``,
    the tree's spec tree, and ``mesh``, a ``parallel.mesh.RankMesh``)
    each leaf is this rank's shard: the squares of leaves split over the
    same axes are summed here, then over those axes (``psum_``, in the
    mesh's axis order, merging sums whose remaining axes agree), and a
    replicated leaf counts once."""
    if mesh is None:
        total = None
        for x in tree_leaves(tree):
            s = torch.sum(torch.square(x.float()))
            total = s if total is None else total + s
        return torch.sqrt(total)
    sums = {}
    for (_, x), (_, spec) in zip(tree_items(tree), tree_items(specs)):
        key = tuple(a for a in mesh.axis_names if a in spec_axes(spec)
                    and mesh.axis_size(a) > 1)
        s = torch.sum(torch.square(x.float()))
        sums[key] = s if key not in sums else sums[key] + s
    while any(sums):
        key = max((k for k in sums if k), key=len)
        s = mesh.psum_(sums.pop(key), key[0])
        rest = key[1:]
        sums[rest] = s if rest not in sums else sums[rest] + s
    return torch.sqrt(sums[()])


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state, *, specs=None,
                  mesh=None):
    """One AdamW step, in place. Returns (params, state, metrics): the
    same trees, updated, and ``{"lr", "grad_norm"}`` as 0-d tensors. On
    one rank of a mesh the trees are its shards and ``specs`` / ``mesh``
    give the clipping norm its sums across the ranks (``global_norm``);
    the update itself is elementwise, per shard.

    Per leaf, in float32: the gradient clipped by the global norm, ``mu =
    b1 * m + (1 - b1) * g``, ``nu = b2 * v + (1 - b2) * g * g``, ``u =
    (mu / bc1) / (sqrt(nu / bc2) + eps)`` plus the decay, and the new
    parameter ``(p - lr * u)`` in its own type. ``b1 * m`` runs in the
    moment's type with ``b1`` rounded to it, as JAX multiplies by a weakly
    typed constant."""
    step = state["step"] + 1
    device = step.device
    gnorm = global_norm(grads, specs, mesh)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.minimum(_f32(1.0, device),
                              _f32(cfg.clip_norm, device) / (gnorm + 1e-9))
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1 - b1 ** sf
    bc2 = 1 - b2 ** sf
    lr = lr_at(cfg, step)
    decay = dict(tree_items(_decay_mask(params)))
    leaves = dict(tree_items(params))
    mus, nus = dict(tree_items(state["mu"])), dict(tree_items(state["nu"]))
    for path, g in tree_items(grads):
        g = g.float()
        if scale is not None:
            g = g * scale
        m, v = mus[path], nus[path]
        m_new = m * torch.full((), b1, dtype=m.dtype, device=device) \
            + (1 - b1) * g
        v_new = v * torch.full((), b2, dtype=v.dtype, device=device) \
            + (1 - b2) * g * g
        for tree, old, new in ((state["mu"], m, m_new),
                               (state["nu"], v, v_new)):
            if old.dtype == new.dtype:
                old.copy_(new)
            else:
                tree_set(tree, path, new)
        leaf = leaves[path]
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if cfg.weight_decay and decay[path]:
            u = u + cfg.weight_decay * leaf.float()
        leaf.copy_((leaf.float() - lr * u).to(leaf.dtype))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
