"""Logical-axis sharding rules: the reference's rule tables and spec
trees, and each rank's shard of a tree.

Counterpart of ``repro.parallel.sharding``, function for function:
``rules_for`` / ``long_context_rules`` map logical axes (``batch``,
``heads``, ``kv_heads``, ``ffn``, ``experts``, ``vocab``, ``cache_seq``,
...) to mesh axes; ``param_specs`` / ``cache_specs`` / ``batch_specs`` /
``opt_state_specs`` give a tree of specs by leaf name and rank. A spec
is a tuple with one entry per dimension: a mesh axis name, a tuple of
them, or None (replicated); ``tuple(P(...))`` of the reference's
``PartitionSpec`` is the same tuple. The spec functions read only
``.shape`` / ``.ndim`` of the leaves and ``axis_names`` /
``devices.shape`` of the mesh, so meta tensors and a stand-in mesh give
the spec tree of any configuration on any mesh without memory.

Rules are installed per thread (``use_rules``), so each thread-rank of
the CPU tests has its own. A rule table that drives the distributed ops
holds the rank's ``parallel.mesh.RankMesh`` under ``"mesh"``, as the
reference's holds its ``Mesh``.

``shard_params`` returns this rank's slice of each leaf, in storage of
its own. ``lshard`` is the identity: the reference annotates activations
with ``with_sharding_constraint`` for GSPMD, but here each rank already
holds its shard, and an explicit program has no layout to constrain. The
port therefore makes no ``lshard`` calls at the reference's sites.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Optional

import torch

_state = threading.local()


def current_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[dict]):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def spec_for(logical_axes, rules=None) -> tuple:
    rules = rules if rules is not None else current_rules()
    if rules is None:
        return ()
    return tuple(rules.get(a) if a else None for a in logical_axes)


def spec_axes(spec) -> tuple:
    """The mesh axes a spec (or one of its entries: an axis name, a tuple
    of them, or None) splits over, in order."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(a for entry in spec for a in spec_axes(entry))


def lshard(x, *logical_axes):
    """The identity (module docstring)."""
    return x


# ---------------------------------------------------------------- rule tables
def _divides(n: int, axis_size: int) -> bool:
    return n > 0 and n % axis_size == 0


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def rules_for(cfg, mesh, *, batch_axes=None) -> dict:
    """Logical->mesh rules for an arch on a mesh (the baseline placement):
    experts on ``data`` (so ``d_ff`` can shard on ``model`` beside them),
    attention heads on ``model`` only when H divides (and KV heads when
    they divide too), and the KV cache's sequence on ``model`` where its
    KV heads cannot shard there."""
    sizes = _sizes(mesh)
    model_ax = "model" if "model" in sizes else None
    m = sizes.get("model", 1)
    if batch_axes is None:
        batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    d = sizes.get("data", 1)
    E = cfg.padded_experts()
    experts_ax = ("data" if (E and E % d == 0 and "data" in sizes)
                  else (model_ax if E and E % m == 0 else None))
    rules = {
        "batch": batch_axes if len(batch_axes) > 1 else (
            batch_axes[0] if batch_axes else None),
        "seq": None,
        "vocab": model_ax,
        "ffn": model_ax if _divides(cfg.d_ff, m) or cfg.d_ff == 0 else None,
        "experts": experts_ax,
        "d_model": None,
        "cache_seq": None,
    }
    heads_ok = _divides(cfg.num_heads, m)
    rules["heads"] = model_ax if heads_ok else None
    rules["kv_heads"] = model_ax if (heads_ok and _divides(cfg.num_kv_heads,
                                                           m)) else None
    rules["ssm_heads"] = model_ax if _divides(cfg.ssm_heads, m) else None
    if cfg.attention_kind != "none" and rules["kv_heads"] is None:
        rules["cache_seq"] = model_ax
    return rules


def long_context_rules(cfg, mesh) -> dict:
    """batch=1 decode: shard the cache sequence dim over `data` instead."""
    rules = rules_for(cfg, mesh, batch_axes=())
    rules["batch"] = None
    rules["cache_seq"] = "data"
    return rules


# ----------------------------------------------------------- spec trees
def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict (path: a tuple of keys)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, (*path, k))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def param_specs(cfg, params, rules: dict, mesh):
    """Spec tree for a params tree (by name pattern): leading stacked-layer
    dims replicated; routed-expert weights shard their E dim on the
    ``experts`` rule and ``d_ff`` on ``ffn``; Mamba2 projections on
    ``ssm_heads``. A dim shards only where the model axis size divides
    it, as in the reference."""
    m = _sizes(mesh).get("model", 1)
    E = cfg.padded_experts()

    def ax_ok(logical, dim):
        mesh_ax = rules.get(logical)
        return mesh_ax if (mesh_ax and dim % m == 0) else None

    def spec(path, leaf):
        ps = _path_str(path)
        nd, shape = leaf.ndim, tuple(leaf.shape)
        lead = lambda n: [None] * (nd - n)  # noqa: E731
        routed = ("shared" not in ps and "residual" not in ps
                  and cfg.num_experts > 0)
        if re.search(r"(w_gate|w_up)$", ps) and routed \
                and nd >= 3 and shape[-3] == E:
            return tuple(lead(3) + [rules.get("experts"), None,
                                    ax_ok("ffn", shape[-1])])
        if re.search(r"w_down$", ps) and routed and nd >= 3 and shape[-3] == E:
            return tuple(lead(3) + [rules.get("experts"),
                                    ax_ok("ffn", shape[-2]), None])
        if re.search(r"(w_gate|w_up)$", ps):
            return tuple(lead(2) + [None, ax_ok("ffn", shape[-1])])
        if re.search(r"w_down$", ps):
            return tuple(lead(2) + [ax_ok("ffn", shape[-2]), None])
        if re.search(r"embed$", ps):
            return (ax_ok("vocab", shape[0]), None)
        if re.search(r"lm_head$", ps):
            return (None, ax_ok("vocab", shape[1]))
        if re.search(r"(wq|wq_b)$", ps):
            return tuple(lead(3) + [None, ax_ok("heads", shape[-2]), None])
        if re.search(r"(wk|wv|wk_b|wv_b)$", ps):
            return tuple(lead(3) + [None, ax_ok("kv_heads", shape[-2]), None])
        if re.search(r"wo$", ps):
            return tuple(lead(2) + [ax_ok("heads", cfg.num_heads), None])
        if re.search(r"(w_z|w_x)$", ps):
            return tuple(lead(2) + [None, ax_ok("ssm_heads", shape[-1])])
        if re.search(r"w_dt$", ps):
            return tuple(lead(2) + [None, ax_ok("ssm_heads", shape[-1])])
        if re.search(r"conv_x_w$", ps):
            return tuple(lead(2) + [None, ax_ok("ssm_heads", shape[-1])])
        if re.search(r"(conv_x_b|norm_scale)$", ps):
            return tuple(lead(1) + [ax_ok("ssm_heads", shape[-1])])
        if re.search(r"out_proj$", ps):
            return tuple(lead(2) + [ax_ok("ssm_heads", shape[-2]), None])
        return (None,) * nd

    return tree_map_with_path(spec, params)


def cache_specs(cache_shapes, rules: dict):
    """Spec tree for a serving cache (``init_cache``'s tree or one of
    meta tensors), by leaf name and rank (hybrid block states carry an
    extra leading dim)."""
    b = rules.get("batch")
    seq = rules.get("cache_seq")
    kvh = rules.get("kv_heads")
    ssh = rules.get("ssm_heads")

    def spec(path, leaf):
        ps = _path_str(path)
        nd = leaf.ndim
        name = ps.rsplit("/", 1)[-1]
        cross = "cross" in ps
        if name in ("k", "v"):
            s = None if cross else seq
            return (None, b, s, kvh, None)
        if name in ("c", "kr"):
            return (None, b, seq, None)
        if name == "conv_x":
            return tuple([None] * (nd - 3) + [b, None, ssh])
        if name in ("conv_B", "conv_C"):
            return tuple([None] * (nd - 3) + [b, None, None])
        if name == "ssd":
            return tuple([None] * (nd - 4) + [b, ssh, None, None])
        if name == "positions":
            return (b, seq)
        if name == "length":
            return (b,)
        return (None,) * nd

    return tree_map_with_path(spec, cache_shapes)


def batch_specs(rules: dict, with_frames: bool = False):
    b = rules.get("batch")
    out = {"tokens": (b, None), "labels": (b, None), "mask": (b, None)}
    if with_frames:
        out["frames"] = (b, None, None)
    return out


def opt_state_specs(pspecs):
    """Optimizer-state specs mirror the parameter specs (step is scalar)."""
    return {"step": (), "mu": pspecs, "nu": pspecs}


# ------------------------------------------------------------ this rank's shard
def leaf_slices(shape, spec, mesh):
    """This rank's (start, stop) on each dimension of a ``shape`` leaf
    under ``spec``, a dim split over several axes taking the first as
    major."""
    out = []
    for i, n in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        k = mesh.axes_size(axes)
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{k} ways over {axes}")
        j = mesh.axes_index(axes)
        out.append((j * (n // k), (j + 1) * (n // k)))
    return out


def shard_leaf(x, spec, mesh):
    """This rank's shard of one leaf (a tensor, meta included, or a
    numpy array) under ``spec``, in storage of its own: one slice per
    dimension."""
    part = x[tuple(slice(a, b) for a, b in leaf_slices(x.shape, spec, mesh))]
    return part.clone() if hasattr(part, "clone") else part.copy()


def shard_params(params, specs, mesh):
    """This rank's shard of every leaf of ``params`` under ``specs``."""
    return tree_map(lambda x, s: shard_leaf(x, s, mesh), params, specs)


class ShardDraw:
    """The sink of ``models.layers.drawing_shards``: what a weight draw
    keeps of each leaf (``models.transformer.init_params_shard``).

    Without a ``plan`` it records: every ``new_leaf`` is a ``meta``
    tensor, kept in ``allocated`` in the order the draw makes them, and
    nothing is drawn. With one, ``plan[i]`` is the i-th allocation's
    (shape, spec): a spec keeps this rank's shard of the leaf, allocated
    at its local shape on ``device``, and the leaf itself is a ``meta``
    tensor whose chunks ``take`` as ``layers.draw_into`` draws them; None
    allocates the leaf whole on its device and draws it as usual (a
    piece the draw copies into another leaf, as the MoE's experts)."""

    def __init__(self, plan=None, mesh=None, device=None):
        self.plan, self.mesh = plan, mesh
        self.device = None if device is None else torch.device(device)
        self.drawing = plan is not None
        self.allocated = []
        self.shards = {}       # id(meta leaf) -> (leaf, slices, shard)
        self.done = 0          # allocations made so far

    def new_leaf(self, shape, dtype, device):
        if not self.drawing:
            w = torch.empty(shape, dtype=dtype, device="meta")
            self.allocated.append(w)
            return w
        want, spec = self.plan[self.done]
        self.done += 1
        if tuple(want) != tuple(shape):
            raise RuntimeError(f"allocation {self.done - 1} of the draw is "
                               f"{shape}, the recorded one {want}")
        if spec is None:
            return torch.empty(shape, dtype=dtype, device=device)
        slices = leaf_slices(shape, spec, self.mesh)
        shard = torch.empty([b - a for a, b in slices], dtype=dtype,
                            device=self.device)
        w = torch.empty(shape, dtype=dtype, device="meta")
        self.shards[id(w)] = (w, slices, shard)
        return w

    def shard_of(self, leaf):
        """The shard kept for ``leaf`` (a meta leaf or a view of one),
        else None."""
        root = leaf if leaf._base is None else leaf._base
        entry = self.shards.get(id(root))
        return None if entry is None else entry[2]

    def take(self, w, row0: int, chunk):
        """Keep this rank's part of rows ``row0 ..`` of ``w`` (a view
        ``[-1, C]`` of a leaf whose shard is kept), drawn as ``chunk``
        [n, C] float32: it is cast into the shard's type as it is
        copied, as the whole draw casts each chunk."""
        root = w if w._base is None else w._base
        _, sl, shard = self.shards[id(root)]
        shape, n, C = tuple(root.shape), chunk.shape[0], chunk.shape[1]
        k = next(j for j in range(len(shape) + 1)
                 if math.prod(shape[j:]) == C)
        if k == 0:      # one row: the whole leaf
            shard.copy_(chunk.view(shape)[tuple(slice(a, b) for a, b in sl)])
            return
        rows, inner = shape[:k], shape[k:]
        last, (a_last, b_last) = rows[-1], sl[k - 1]
        inner_index = tuple(slice(a, b) for a, b in sl[k:])
        r, end = row0, row0 + n
        while r < end:      # runs of rows along the last row dim
            unit, at = divmod(r, last)
            stop = min(end, r - at + last)
            outer = _unravel(unit, rows[:-1])
            lo, hi = max(at, a_last), min(at + stop - r, b_last)
            if lo < hi and all(a <= o < b for o, (a, b) in zip(outer, sl)):
                src = chunk[r - row0 + lo - at:r - row0 + hi - at]
                src = src.view(hi - lo, *inner)[(slice(None),) + inner_index]
                dst = tuple(o - a for o, (a, _) in zip(outer, sl))
                shard[dst + (slice(lo - a_last, hi - a_last),)].copy_(src)
            r = stop


def _unravel(i: int, shape) -> tuple:
    out = []
    for n in reversed(shape):
        i, j = divmod(i, n)
        out.append(j)
    return tuple(reversed(out))
