"""The loss and the train steps (with remat, the MoE aux loss and gradient
accumulation).

PyTorch counterpart of ``repro.training.train``. ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over the params tree's leaves
(``value_and_grad``); the optimizer updates the tree in place
(``optimizer.apply_updates``), so a step returns the trees it was given.
The forward runs in train mode on its plain routes and launches no kernel.

Under sharding rules (``parallel.sharding.use_rules``) the loss and the
steps raise: the forward's collectives (``parallel.mesh``) have no
backward yet, so a sharded step would give wrong gradients (ROADMAP
A11b).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.training import optimizer as OPT


def _check_unsharded():
    if SH.current_rules() is not None:
        raise NotImplementedError(
            "training under sharding rules is not ported (ROADMAP A11b): "
            "the forward's collectives have no backward")


def lm_loss(logits, labels, mask=None):
    """Next-token cross-entropy; labels already shifted by the pipeline."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        mask = torch.ones_like(ll)
    return -(ll * mask).sum() / torch.clip(mask.sum(), min=1.0)


def make_loss_fn(cfg: ModelConfig, *, aux_weight: float = 0.01,
                 dispatch: str = "auto", remat: bool = False):
    """loss_fn(params, batch) -> (total, {"loss", "aux_loss"}), where
    total = loss + aux_weight * aux (the MoE load-balance loss, 0 for
    other families); the parts are detached."""
    def loss_fn(params, batch):
        _check_unsharded()
        logits, _, aux = T.forward(
            params, cfg, batch["tokens"], mode="train",
            encoder_input=batch.get("frames"), dispatch=dispatch, remat=remat)
        loss = lm_loss(logits, batch["labels"], batch.get("mask"))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        total = loss + aux_weight * aux
        return total, {"loss": loss.detach(), "aux_loss": aux.detach()}
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((total, parts), grads): ``loss_fn``'s value and its gradient with
    respect to every leaf of ``params`` (a tree of the same structure, in
    each leaf's type; zeros for a leaf the loss does not reach, as JAX
    gives). The caller's tensors are not marked: the leaves are detached
    views that require grad."""
    paths = [path for path, _ in OPT.tree_items(params)]
    leaves = [leaf.detach().requires_grad_()
              for leaf in OPT.tree_leaves(params)]
    with torch.enable_grad():
        total, parts = loss_fn(OPT.tree_from(paths, leaves), batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(leaves, grads)]
    return (total.detach(), parts), OPT.tree_from(paths, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: OPT.OptimizerConfig, *,
                    aux_weight: float = 0.01, dispatch: str = "auto",
                    remat: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics): one gradient of the loss and one AdamW update, in place."""
    loss_fn = make_loss_fn(cfg, aux_weight=aux_weight, dispatch=dispatch,
                           remat=remat)

    def train_step(params, opt_state, batch):
        (total, parts), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, om = OPT.apply_updates(opt_cfg, params, grads,
                                                  opt_state)
        return params, opt_state, dict(parts, total_loss=total, **om)

    return train_step


def make_train_step_accum(cfg: ModelConfig, opt_cfg: OPT.OptimizerConfig, *,
                          accum_steps: int, aux_weight: float = 0.01,
                          dispatch: str = "auto", remat: bool = False):
    """Gradient-accumulation train step: the batch's leading dim is split
    into ``accum_steps`` micro-batches run one after another, their
    gradients summed in fp32 and divided by ``accum_steps`` before one
    update. The global batch must divide by ``accum_steps``."""
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
        params, opt_state, om = OPT.apply_updates(opt_cfg, params, grads,
                                                  opt_state)
        return params, opt_state, dict(total_loss=lsum / accum_steps, **om)

    return train_step
