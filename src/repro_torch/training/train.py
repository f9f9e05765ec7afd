"""The loss and the train steps (with remat, the MoE aux loss and gradient
accumulation), on one process or one rank of a mesh.

PyTorch counterpart of ``repro.training.train``. ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over the params tree's leaves
(``value_and_grad``); the optimizer updates the tree in place
(``optimizer.apply_updates``), so a step returns the trees it was given.
The forward runs in train mode on its plain routes and launches no kernel.

Under sharding rules (``parallel.sharding.use_rules``, the rank's
``parallel.mesh.RankMesh`` under ``rules["mesh"]``) each rank holds its
shard of the params and of the optimizer state (``sharding.shard_params``
under ``param_specs`` / ``opt_state_specs``) and its rows of the batch
(``data.pipeline.sharded_batches``), and a step gives it its shard of
the update the reference's GSPMD step computes, which differentiates the
global function. The forward's collectives carry their backward
(``parallel.mesh``); the step adds what the global function needs beyond
them:

* the loss divides by the global mask sum: its numerator and denominator
  are summed over the batch axes (a ``psum``, identity backward);
* the MoE aux loss enters the total once: it is the mean over the batch
  ranks of each rank's (the same on every rank where the dispatch
  gathers the batch's rows), summed in the same all-reduce;
* a leaf replicated over a batch axis has its gradient summed over that
  axis (``reduce_grads``);
* the clipping norm sums a split leaf's squares over the axes that split
  it and counts a replicated leaf once (``optimizer.global_norm``).

Every family runs under rules; an audio batch carries this rank's rows
of its ``frames`` (``sharded_batches(..., frames=True)``).
"""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.training import optimizer as OPT


def _nll_sums(logits, labels, mask=None):
    """(-sum of the masked log-likelihoods, sum of the mask)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        mask = torch.ones_like(ll)
    return -(ll * mask).sum(), mask.sum()


def lm_loss(logits, labels, mask=None):
    """Next-token cross-entropy; labels already shifted by the pipeline."""
    num, den = _nll_sums(logits, labels, mask)
    return num / torch.clip(den, min=1.0)


def _batch_sums(rules, num, den, aux):
    """(num, den, aux) over every rank's rows: the sums of ``num`` and
    ``den`` and the mean of ``aux`` over the batch axes, in one
    all-reduce per axis (identity backward: the loss is replicated)."""
    axes = SH.spec_axes(rules.get("batch"))
    if not axes:
        return num, den, aux
    mesh = L.rule_mesh(rules)
    v = torch.stack([num, den.to(num.dtype), aux.to(num.dtype)])
    for a in axes:
        v = mesh.psum(v, a)
    return v[0], v[1], v[2] / mesh.axes_size(axes)


def make_loss_fn(cfg: ModelConfig, *, aux_weight: float = 0.01,
                 dispatch: str = "auto", remat: bool = False):
    """loss_fn(params, batch) -> (total, {"loss", "aux_loss"}), where
    total = loss + aux_weight * aux (the MoE load-balance loss, 0 for
    other families); the parts are detached. Under sharding rules both
    are the global batch's (module docstring)."""
    def loss_fn(params, batch):
        logits, _, aux = T.forward(
            params, cfg, batch["tokens"], mode="train",
            encoder_input=batch.get("frames"), dispatch=dispatch, remat=remat)
        num, den = _nll_sums(logits, batch["labels"], batch.get("mask"))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=num.device)
        rules = SH.current_rules()
        if rules is not None:
            num, den, aux = _batch_sums(rules, num, den, aux)
        loss = num / torch.clip(den, min=1.0)
        total = loss + aux_weight * aux
        return total, {"loss": loss.detach(), "aux_loss": aux.detach()}
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((total, parts), grads): ``loss_fn``'s value and its gradient with
    respect to every leaf of ``params`` (a tree of the same structure, in
    each leaf's type; zeros for a leaf the loss does not reach, as JAX
    gives). The caller's tensors are not marked: the leaves are detached
    views that require grad. Under sharding rules the gradients are this
    rank's parts, before ``reduce_grads``."""
    paths = [path for path, _ in OPT.tree_items(params)]
    leaves = [leaf.detach().requires_grad_()
              for leaf in OPT.tree_leaves(params)]
    with torch.enable_grad():
        total, parts = loss_fn(OPT.tree_from(paths, leaves), batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(leaves, grads)]
    return (total.detach(), parts), OPT.tree_from(paths, grads)


@functools.lru_cache(maxsize=None)
def _global_params(cfg: ModelConfig):
    """The global tree's shapes, as meta tensors. They are built outside
    any dispatch mode: a tree of shapes is neither the step's work nor
    its memory, which a dry run's FLOP counter and memory tally
    (``launch.dryrun``) count."""
    with _disable_current_modes():
        return T.init_params_meta(cfg, "float32")


def rank_specs(cfg: ModelConfig, rules, params):
    """(mesh, specs): the rank's mesh and the params' spec tree under
    ``rules`` (``param_specs`` of the global shapes), checked against the
    shard shapes ``params`` holds."""
    mesh = L.rule_mesh(rules)
    full = _global_params(cfg)
    specs = SH.param_specs(cfg, full, rules, mesh)
    for (path, leaf), (_, g), (_, spec) in zip(
            OPT.tree_items(params), OPT.tree_items(full),
            OPT.tree_items(specs)):
        want = tuple(n // mesh.axes_size(spec[i] if i < len(spec) else None)
                     for i, n in enumerate(g.shape))
        if tuple(leaf.shape) != want:
            raise ValueError(f"{'/'.join(path)}: a shard of {tuple(g.shape)} "
                             f"under {spec} is {want}, not "
                             f"{tuple(leaf.shape)}")
    return mesh, specs


def reduce_grads(grads, specs, mesh, rules):
    """Each gradient summed IN PLACE over the batch axes its leaf is not
    split over (a replicated leaf's parts, one per rank's rows)."""
    batch = SH.spec_axes(rules.get("batch"))
    for (_, g), (_, spec) in zip(OPT.tree_items(grads),
                                 OPT.tree_items(specs)):
        split = SH.spec_axes(spec)
        for a in batch:
            if a not in split:
                mesh.psum_(g, a)
    return grads


def _update(cfg, opt_cfg, params, grads, opt_state, metrics):
    """The AdamW update, after the gradient sums of a sharded step."""
    rules = SH.current_rules()
    mesh = specs = None
    if rules is not None:
        mesh, specs = rank_specs(cfg, rules, params)
        reduce_grads(grads, specs, mesh, rules)
    params, opt_state, om = OPT.apply_updates(opt_cfg, params, grads,
                                              opt_state, specs=specs,
                                              mesh=mesh)
    return params, opt_state, dict(metrics, **om)


def make_train_step(cfg: ModelConfig, opt_cfg: OPT.OptimizerConfig, *,
                    aux_weight: float = 0.01, dispatch: str = "auto",
                    remat: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics): one gradient of the loss and one AdamW update, in place."""
    loss_fn = make_loss_fn(cfg, aux_weight=aux_weight, dispatch=dispatch,
                           remat=remat)

    def train_step(params, opt_state, batch):
        (total, parts), grads = value_and_grad(loss_fn, params, batch)
        return _update(cfg, opt_cfg, params, grads, opt_state,
                       dict(parts, total_loss=total))

    return train_step


def make_train_step_accum(cfg: ModelConfig, opt_cfg: OPT.OptimizerConfig, *,
                          accum_steps: int, aux_weight: float = 0.01,
                          dispatch: str = "auto", remat: bool = False):
    """Gradient-accumulation train step: the batch's leading dim (a
    rank's rows under sharding rules) is split into ``accum_steps``
    micro-batches run one after another, their gradients summed in fp32
    and divided by ``accum_steps`` before one update. The batch must
    divide by ``accum_steps``."""
    loss_fn = make_loss_fn(cfg, aux_weight=aux_weight, dispatch=dispatch,
                           remat=remat)

    def train_step(params, opt_state, batch):
        micros = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                               *v.shape[1:]) for k, v in batch.items()}
        gsum = OPT.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=OPT.tree_leaves(params)[0].device)
        for i in range(accum_steps):
            (total, _), grads = value_and_grad(
                loss_fn, params, {k: v[i] for k, v in micros.items()})
            gsum = OPT.tree_map(lambda a, g: a + g.float(), gsum, grads)
            lsum = lsum + total
            del grads
        grads = OPT.tree_map(lambda g: g / accum_steps, gsum)
        del gsum
        return _update(cfg, opt_cfg, params, grads, opt_state,
                       dict(total_loss=lsum / accum_steps))

    return train_step
