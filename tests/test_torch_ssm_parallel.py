"""Port parity, the SSM and hybrid families under sharding rules: the
head-split Mamba2 mixer (``models/ssm.py``'s ``SSMHeads``: the split
projections and x conv, whole B / C at the groups a rank's heads read,
the gated norm's cross-rank sum of squares, the row-parallel
``out_proj``) and zamba2's shared attention block on split heads, every
rank a thread with its shard of the weights, cache and batch, against
the reference's UNSHARDED functions on the same weights (the
reference's ``init_params``, bridged through numpy):

* serving (fp32; bf16 runs at full width in ``chip_smoke.py`` 13e-f): a
  prefill, 2 decode steps fed the reference's greedy tokens and a
  3-token extension (decode mode from the cache's states), logits 1e-4,
  greedy tokens equal, the collectives of each decode step as designed;
* training: the loss (1e-5), each gradient shard after ``reduce_grads``
  and each updated shard after one step (1e-4 relative L2);
* mamba2-780m and zamba2-7b with 3 layers (one block and a one-layer
  tail), ``.reduced()``, on meshes (1, 2), (2, 1) and (2, 2), and mamba2
  served with ``ssm_ngroups=2`` on model 2 (a rank's heads form one
  group) and model 4 (two ranks share a group);
* the gated norm's backward flipped to the identity fails the gradient
  check."""
import dataclasses
import functools

import numpy as np
import pytest

from repro_torch.bridge import shard_from_numpy
from repro_torch.data import pipeline as TDP
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import RankMesh
from _torch_mesh import rows, run_mesh
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_sharded import (global_batch, pair, per_step_collectives,
                            port_stream, rank_train, ref_stream, ref_train,
                            tokens, train_errors)

#: name -> (arch, config changes)
VARIANTS = {
    "ssm": ("mamba2-780m", ()),
    "ssm-g2": ("mamba2-780m", (("ssm_ngroups", 2),)),
    "hybrid": ("zamba2-7b", (("num_layers", 3),)),
}
B, S, M, STEPS = 4, 10, 16, 2
DATA = TDP.DataConfig(seq_len=16, global_batch=4)
#: name -> (variant, mesh, kernel routes)
SERVE = {
    "ssm-1x2": ("ssm", (1, 2), False),
    "ssm-2x1": ("ssm", (2, 1), False),
    "ssm-2x2-kernel": ("ssm", (2, 2), True),
    "ssm-g2-1x2": ("ssm-g2", (1, 2), False),
    "ssm-g2-1x4-kernel": ("ssm-g2", (1, 4), True),
    "hybrid-1x2-kernel": ("hybrid", (1, 2), True),
    "hybrid-2x1": ("hybrid", (2, 1), False),
    "hybrid-2x2": ("hybrid", (2, 2), False),
}
#: (variant, mesh); ssm_ngroups=2 is served only: its gradients take the
#: same enter of the whole B / C as one group shared by every rank
TRAIN = [("ssm", (1, 2)), ("ssm", (2, 1)), ("ssm", (2, 2)),
         ("hybrid", (1, 2)), ("hybrid", (2, 1)), ("hybrid", (2, 2))]


def _mesh_id(shape):
    return "x".join(map(str, shape))


def _variant(variant):
    """(jax cfg, numpy weights, port cfg) of a variant. ``ssm-g2`` takes
    the ``ssm`` draw with B's and C's projections, convs and biases
    widened to two groups, group 1 of B being C's and of C B's (one
    compile of the reference's ``init_params`` fewer; the groups
    differ)."""
    if variant != "ssm-g2":
        return pair(*VARIANTS[variant])
    jcfg, np_params, tcfg = pair(*VARIANTS["ssm"])
    jcfg = dataclasses.replace(jcfg, ssm_ngroups=2)
    tcfg = dataclasses.replace(tcfg, ssm_ngroups=2)
    m = dict(np_params["layers"]["mixer"])
    for b, c in (("w_B", "w_C"), ("conv_B_w", "conv_C_w"),
                 ("conv_B_b", "conv_C_b")):
        m[b], m[c] = (np.concatenate([m[b], m[c]], -1),
                      np.concatenate([m[c], m[b]], -1))
    layers = dict(np_params["layers"], mixer=m)
    return jcfg, dict(np_params, layers=layers), tcfg


@functools.cache
def _inputs(variant):
    """(numpy weights, port cfg, prompt, extension, the reference's
    logits and greedy tokens): one reference run per variant."""
    jcfg, np_params, tcfg = _variant(variant)
    toks = tokens(tcfg, B, S)
    ext = tokens(tcfg, B, 3, seed=1)
    want, want_tok = ref_stream(jcfg, np_params, toks, M, STEPS, ext)
    return np_params, tcfg, toks, ext, want, want_tok


@pytest.mark.parametrize("case", SERVE)
def test_sharded_serving_matches_reference(case):
    variant, shape, kernel = SERVE[case]
    np_params, tcfg, toks, ext, want, want_tok = _inputs(variant)

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        got = port_stream(tcfg, np_params, toks, M, STEPS, rules, mesh,
                          ext=ext, impl="kernel" if kernel else "gather",
                          forced=want_tok)
        return rows(mesh, rules, B), got, per_step_collectives(tcfg, mesh)

    V = tcfg.vocab_size
    for sl, (got, tok, colls), per_step in run_mesh(shape, rank):
        np.testing.assert_allclose(got[..., :V], want[:, sl, :V], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tok, want_tok[sl])
        assert colls == [per_step] * STEPS


def test_rank_shapes_follow_the_head_split():
    """On (1, 2) the split leaves and the cache's ``conv_x`` / ``ssd``
    hold a rank's half of the heads; B / C's weights, conv states and the
    per-head leaves stay whole; ``rules_for`` names ``ssm_heads``."""
    np_params, tcfg = _inputs("ssm")[:2]

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        p = shard_from_numpy(np_params, SH.param_specs(tcfg, np_params,
                                                       rules, mesh),
                             mesh, "cpu")["layers"]["mixer"]
        c = T.init_cache_shard(tcfg, 2, 8, rules, mesh, "float32",
                               "cpu")["layers"]
        return (rules["ssm_heads"],
                {k: tuple(v.shape) for k, v in p.items()},
                {k: tuple(v.shape) for k, v in c.items()})

    H, di, N = tcfg.ssm_heads, tcfg.ssm_d_inner, tcfg.ssm_state
    d, L, K = tcfg.d_model, tcfg.num_layers, tcfg.ssm_conv_dim
    for axis, p, c in run_mesh((1, 2), rank):
        assert axis == "model"
        assert (p["w_z"], p["w_x"], p["w_dt"], p["out_proj"]) == (
            (L, d, di // 2), (L, d, di // 2), (L, d, H // 2), (L, di // 2, d))
        assert (p["conv_x_w"], p["conv_x_b"], p["norm_scale"]) == (
            (L, K, di // 2), (L, di // 2), (L, di // 2))
        assert (p["w_B"], p["conv_B_w"], p["dt_bias"], p["A_log"],
                p["D"]) == ((L, d, N), (L, K, N), (L, H), (L, H), (L, H))
        assert c == {"conv_x": (L, 2, K - 1, di // 2),
                     "conv_B": (L, 2, K - 1, N), "conv_C": (L, 2, K - 1, N),
                     "ssd": (L, 2, H // 2, tcfg.ssm_head_dim, N)}


@functools.cache
def _train_ref(variant):
    jcfg, np_params, tcfg = _variant(variant)
    return ref_train(jcfg, np_params, global_batch(tcfg, DATA))


def _train_errors(variant, shape):
    _, np_params, tcfg = _variant(variant)
    ref = _train_ref(variant)

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        return train_errors(rank_train(tcfg, np_params, DATA, mesh, rules),
                            ref)

    return run_mesh(shape, rank)


@pytest.mark.parametrize("variant,shape", TRAIN,
                         ids=[f"{v}-{_mesh_id(s)}" for v, s in TRAIN])
def test_sharded_train_step_matches_reference(variant, shape):
    for losses, grads, params in _train_errors(variant, shape):
        assert max(losses) <= 1e-5, losses
        worst = max(grads, key=grads.get)
        assert grads[worst] <= 1e-4, ("grad", worst, grads[worst])
        worst = max(params, key=params.get)
        assert params[worst] <= 1e-4, ("param", worst, params[worst])


def test_gated_norm_backward_is_needed(monkeypatch):
    """With the gated norm's psum backward flipped to the identity (each
    rank keeping its partial cotangent of the rms), the gradient check
    on (1, 2) fails for the leaves upstream of a norm, and holds for the
    final norm, past every mixer."""
    psum = RankMesh.psum
    monkeypatch.setattr(RankMesh, "psum",
                        lambda self, x, axis, grad="identity":
                        psum(self, x, axis, "identity"))
    for _, grads, _ in _train_errors("ssm", (1, 2)):
        assert grads["layers/mixer/D"] > 1e-2
        assert grads["layers/mixer/w_x"] > 1e-2
        assert grads["final_norm/scale"] <= 1e-4
