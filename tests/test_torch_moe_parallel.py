"""Port parity, the MoE layer under sharding rules: routed experts split
over ``experts`` and their ``d_ff`` over ``ffn`` (the dense and scatter
dispatches: each rank's experts over every token, then a ``psum``)
against the reference's unsharded ``apply_moe``; and the expert-parallel
dispatch over two all-to-alls against the reference's
``_moe_expert_parallel`` (a ``shard_map`` on the Auto 1x1 mesh) at
W = 1, drops included, and against its exact ``_moe_dense`` at W = 2
and 4 where nothing drops. Ranks are threads (``_torch_mesh``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as JMOE
from repro.parallel import sharding as JSH
from repro_torch.bridge import shard_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import moe as MOE
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import RankMesh
from _torch_mesh import auto_mesh, rows, run_mesh
from _torch_parity import one_torch_thread  # noqa: F401

ARCH = "qwen2-moe-a2.7b"
TOL = 3e-5


@functools.cache
def _layer(n_experts):
    """(jax cfg, port cfg, numpy MoE params): reduced qwen2-moe with
    ``n_experts`` routed experts (padded to 16), one layer's weights drawn
    by the port's ``init_moe`` from a seed."""
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(),
                               num_experts=n_experts)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               num_experts=n_experts)
    p = MOE.init_moe(tcfg, torch.Generator().manual_seed(n_experts),
                     torch.float32)
    return jcfg, tcfg, jax.tree_util.tree_map(lambda t: t.numpy(), p)


def _x(tcfg, B, S, seed=0, skew=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    return x + skew * x[:1, :1]          # a shared direction crowds experts


def _ref(fn, p, x, cfg, rules=None, **kw):
    """A reference MoE function under one jit (under ``rules`` on the
    Auto 1x1 mesh where given)."""
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    call = jax.jit(lambda p, x: fn(p, x, cfg, **kw))
    if rules is None:
        return call(jp, x)
    with JSH.use_rules(rules), jax.set_mesh(rules["mesh"]):
        return call(jp, x)


@pytest.mark.parametrize("n_experts", [4, 12])
def test_split_experts_match_reference(n_experts):
    """At (2, 2) under ``rules_for``: experts on ``data``, ``d_ff`` on
    ``model``, each rank its rows; the dense (4 experts) or scatter (12)
    dispatch agrees with the reference's unsharded ``apply_moe``, and so
    does the load-balance loss (routing sees every token)."""
    jcfg, tcfg, p = _layer(n_experts)
    x = _x(tcfg, 4, 6)
    want, want_aux = _ref(JMOE.apply_moe, p, x, jcfg)

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        sp = shard_from_numpy(p, SH.param_specs(tcfg, p, rules, mesh), mesh,
                              "cpu")
        sl = rows(mesh, rules, 4)
        with SH.use_rules(rules):
            out, aux = MOE.apply_moe(sp, torch.from_numpy(x[sl]), tcfg)
        return sl, out.numpy(), float(aux), sp["w_gate"].shape, \
            dict(mesh.collectives)

    E = tcfg.padded_experts()
    for sl, out, aux, shape, colls in run_mesh((2, 2), rank):
        assert shape == (E // 2, tcfg.d_model, tcfg.d_ff // 2)
        np.testing.assert_allclose(out, np.asarray(want)[sl], rtol=TOL,
                                   atol=TOL)
        assert abs(aux - float(want_aux)) <= 1e-5
        # rows gathered over data; experts and d_ff summed; the shared
        # branch's d_ff slice summed
        assert colls == {"all-gather": 1, "all-reduce": 3}


def test_expert_parallel_w1_matches_reference_with_drops():
    """On one rank the expert-parallel dispatch is the reference's on
    the Auto 1x1 mesh, slot for slot: skewed routing overflows the
    experts' ``cap_e`` rows, and the same slots drop on both sides."""
    jcfg, tcfg, p = _layer(12)
    x = _x(tcfg, 4, 32, seed=1, skew=3.0)
    jrules = dict(JSH.rules_for(jcfg, auto_mesh()), mesh=auto_mesh(),
                  moe_a2a=True)
    w, idx, _ = _ref(JMOE.route, p, x, jcfg)
    want = _ref(lambda p, x, cfg: JMOE._moe_expert_parallel(
        p, x, w, idx, cfg, jrules), p, x, jcfg, jrules)
    exact = _ref(lambda p, x, cfg: JMOE._moe_dense(p, x, w, idx, cfg),
                 p, x, jcfg)
    mesh = RankMesh(("data", "model"), (1, 1), 0, "cpu")
    rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh, moe_a2a=True)
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    with SH.use_rules(rules):
        out, _ = MOE.apply_moe(tp, torch.from_numpy(x), tcfg)
    shared = MOE._swiglu(torch.from_numpy(x), tp["shared"]).numpy()
    np.testing.assert_allclose(out.numpy() - shared, np.asarray(want),
                               rtol=TOL, atol=TOL)
    assert int(mesh.moe_dropped) > 0
    assert np.abs(np.asarray(want) - np.asarray(exact)).max() > 1e-2


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
def test_expert_parallel_matches_dense(shape):
    """W = 2 and 4 ranks on ``data`` (and d_ff split over ``model`` at
    (2, 2)), 2 rows of 3 tokens a rank: no slot drops, and every rank's
    rows equal the reference's exact all-experts dispatch; two
    all-to-alls a call, plus the ``d_ff`` sums where it is split. The
    capacity factor is the padded expert count, so that a rank's buckets
    hold all its slots and an expert's rows all the tokens of every rank
    whatever the draw routes. At the default 1.3 a draw that crowds one
    expert drops slots by design, as the reference does
    (``test_expert_parallel_w1_matches_reference_with_drops``)."""
    jcfg, tcfg, p = _layer(12)
    B = 2 * shape[0]
    x = _x(tcfg, B, 3, seed=2)
    w, idx, _ = _ref(JMOE.route, p, x, jcfg)
    want = _ref(lambda p, x, cfg: JMOE._moe_dense(p, x, w, idx, cfg),
                p, x, jcfg)

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh, moe_a2a=True)
        sp = shard_from_numpy(p, SH.param_specs(tcfg, p, rules, mesh), mesh,
                              "cpu")
        sl = rows(mesh, rules, B)
        ws, ids, _ = MOE.route(sp, torch.from_numpy(x[sl]), tcfg)
        with SH.use_rules(rules):
            out = MOE._moe_expert_parallel(
                sp, torch.from_numpy(x[sl]), ws, ids, tcfg, rules,
                capacity_factor=float(tcfg.padded_experts(MOE.EXPERT_AXIS_PAD)))
        return sl, out.numpy(), int(mesh.moe_dropped), dict(mesh.collectives)

    ffn = {"all-reduce": 1} if shape[1] > 1 else {}
    for sl, out, dropped, colls in run_mesh(shape, rank):
        np.testing.assert_allclose(out, np.asarray(want)[sl], rtol=TOL,
                                   atol=TOL)
        assert dropped == 0
        assert colls == {"all-to-all": 2, **ffn}


@pytest.mark.parametrize("n_experts,a2a,picked", [
    (12, True, "all-to-all"), (12, False, "all-gather"),
    (4, True, "all-gather")])
def test_auto_picks_expert_parallel(n_experts, a2a, picked):
    """``dispatch="auto"`` takes the expert-parallel path under
    ``rules["moe_a2a"]`` with experts split and more than 8 of them, as
    the reference's does; otherwise the gathered dense or scatter
    dispatch."""
    _, tcfg, p = _layer(n_experts)
    x = _x(tcfg, 4, 2)

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh, moe_a2a=a2a)
        sp = shard_from_numpy(p, SH.param_specs(tcfg, p, rules, mesh), mesh,
                              "cpu")
        with SH.use_rules(rules):
            MOE.apply_moe(sp, torch.from_numpy(x[rows(mesh, rules, 4)]), tcfg)
        return dict(mesh.collectives)

    for colls in run_mesh((2, 1), rank):
        assert picked in colls
        assert ("all-to-all" in colls) == (picked == "all-to-all")
