"""Port parity, the sharded train step: ``training.train`` under
sharding rules, every rank a thread with its shard of the weights
(``shard_from_numpy`` of one seeded fp32 draw, which the reference takes
whole) and its rows of the batch (``data.pipeline.sharded_batches``),
against the reference's UNSHARDED ``make_train_step`` on the same
weights and batch: GSPMD's sharded step differentiates that global
function. (The reference's own sharded-step test fails under jax 0.9,
ROADMAP "Reference caveats".)

For dense, vlm, GQA (query heads split, the one K/V head whole), MLA
(with a low-rank query) and moe (the scatter dispatch, experts on
``data``), on meshes (1, 2), (2, 1) and (2, 2): one step's loss (1e-5
relative), each rank's gradient shard against its slice of the
reference's gradient (1e-5 relative L2) and its updated params (1e-4).
Also: accumulation against one step, ``sharded_batches`` rows against
``synth_batch``, the expert-parallel dispatch's gradient against a
central finite difference in float64 (it routes per rank, so it has no
unsharded twin), and accumulation under rules for the ssm, hybrid and
audio families (their parity with the reference's step is in
``test_torch_ssm_parallel.py`` and ``test_torch_audio_parallel.py``)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro_torch.bridge import shard_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TDP
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import RankMesh
from repro_torch.training import optimizer as TOPT
from repro_torch.training import train as TTR
from _torch_mesh import run_mesh
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_sharded import OPT_KW, flat as _flat, float64_math, global_batch, rank_train
from _torch_sharded import ref_train, rel as _rel, shard_index as _index

# family -> (arch, config changes)
FAMILIES = {
    "dense": ("tinyllama-1.1b", ()),
    "vlm": ("chameleon-34b", ()),
    "gqa": ("tinyllama-1.1b", (("num_heads", 8), ("num_kv_heads", 1))),
    "mla": ("minicpm3-4b", (("q_lora_rank", 32),)),
    "moe": ("qwen2-moe-a2.7b", (("num_experts", 12),)),
}
MESHES = [(1, 2), (2, 1), (2, 2)]
DATA = dict(seq_len=16, global_batch=4)


@functools.cache
def _case(family):
    """(tcfg, numpy fp32 weights drawn by the port's ``init_params``)."""
    arch, changes = FAMILIES[family]
    tcfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "float32")
    return tcfg, TOPT.tree_map(lambda t: t.numpy(), tp)


@functools.cache
def _reference(family):
    """The reference's unsharded loss, gradient and one train step on
    the whole batch (``_torch_sharded.ref_train``)."""
    arch, changes = FAMILIES[family]
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **dict(changes))
    tcfg, np_params = _case(family)
    return ref_train(jcfg, np_params, global_batch(tcfg, TDP.DataConfig(**DATA)))


def _rank_step(family, mesh):
    """This rank's loss parts, gradient shards and updated params
    (``_torch_sharded.rank_train``)."""
    tcfg, np_params = _case(family)
    rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
    return rank_train(tcfg, np_params, TDP.DataConfig(**DATA), mesh, rules)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_matches_reference(family, shape):
    ref = _reference(family)
    for r in run_mesh(shape, lambda mesh: _rank_step(family, mesh)):
        for k in ("total", "loss"):
            assert _rel(r[k], ref[k]) <= 1e-5, (k, r[k], ref[k])
        assert _rel(r["step_total"], ref["total"]) <= 1e-5
        assert set(r["grads"]) == set(ref["grads"])
        for k, idx in r["where"].items():
            assert _rel(r["grads"][k], ref["grads"][k][idx]) <= 1e-5, \
                ("grad", k, _rel(r["grads"][k], ref["grads"][k][idx]))
            assert _rel(r["params"][k], ref["params"][k][idx]) <= 1e-4, \
                ("param", k)


def test_accumulation_matches_one_step():
    """``make_train_step_accum`` under rules on (2, 2) (each rank's 2 rows
    as 2 micro-batches of 1) against the unsharded one step on the same
    unmasked batch (with a mask, the micro-batches' own denominators
    differ from the whole batch's)."""
    tcfg, np_params = _case("dense")
    dcfg = TDP.DataConfig(**DATA)
    ocfg = TOPT.OptimizerConfig(**OPT_KW)
    whole = TDP.synth_batch(tcfg, dcfg, 0, "cpu")
    whole["mask"] = torch.ones_like(whole["mask"])
    ref = {k: torch.from_numpy(v).clone() for k, v in _flat(np_params).items()}
    p = TOPT.tree_from([tuple(k.split("/")) for k in ref], list(ref.values()))
    p, _, want = TTR.make_train_step(tcfg, ocfg)(p, TOPT.init_opt_state(p),
                                                 whole)
    want_p = {k: v.numpy() for k, v in _flat(p).items()}

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        specs = SH.param_specs(tcfg, np_params, rules, mesh)
        mine = {k: SH.shard_leaf(v, SH.batch_specs(rules)[k], mesh)
                for k, v in whole.items()}
        q = shard_from_numpy(np_params, specs, mesh, "cpu")
        with SH.use_rules(rules):
            q, _, m = TTR.make_train_step_accum(tcfg, ocfg, accum_steps=2)(
                q, TOPT.init_opt_state(q), mine)
        where = [_index(v.shape, s, mesh) for v, (_, s) in zip(
            _flat(np_params).values(), TOPT.tree_items(specs))]
        return float(m["total_loss"]), _flat(q), where

    for loss, q, where in run_mesh((2, 2), rank):
        assert _rel(loss, float(want["total_loss"])) <= 1e-5
        for (k, v), idx in zip(q.items(), where):
            assert _rel(v.numpy(), want_p[k][idx]) <= 1e-4, k


def test_sharded_batches_rows():
    """Each rank's rows are its row-major part of ``synth_batch`` over
    the batch axes (here ``pod`` and ``data``), on the mesh's device; a
    batch that does not divide raises."""
    cfg = get_config("tinyllama-1.1b").reduced()
    dcfg = TDP.DataConfig(seq_len=8, global_batch=8)
    spec = (("pod", "data"), None)

    def rank(mesh):
        got = list(TDP.sharded_batches(cfg, dcfg, mesh, spec, 2))
        return mesh.axes_index(("pod", "data")), got

    for i, got in run_mesh((2, 2, 1), rank, axes=("pod", "data", "model")):
        assert len(got) == 2
        for step, b in enumerate(got):
            whole = TDP.synth_batch(cfg, dcfg, step, "cpu")
            for k, v in whole.items():
                assert b[k].device.type == "cpu"
                torch.testing.assert_close(b[k], v[2 * i:2 * i + 2],
                                           rtol=0, atol=0)
    mesh = RankMesh.dry(("data", "model"), (3, 1))
    with pytest.raises(ValueError, match="does not split"):
        next(TDP.sharded_batches(cfg, dcfg, mesh, ("data", None), 1))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_expert_parallel_gradient_finite_difference(shape):
    """The expert-parallel dispatch (``rules["moe_a2a"]``, experts on
    ``data``) in float64: the directional derivative of the global
    objective F = sum over the data ranks of <out_r, c_r> + aux_r / n
    (the train step's: each rank's aux enters once over the batch) from
    the sharded backward (the all-to-alls' and the ``enter`` ops'
    conjugates, then the batch sums of ``reduce_grads``) against a
    central finite difference of F along a random direction."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              num_experts=12)
    full = T.init_params(cfg, torch.Generator().manual_seed(0), "float32")
    moe = TOPT.tree_map(lambda t: t[0].double(), full["layers"]["moe"])
    g = np.random.default_rng(0)
    B, S, d = 4, 8, cfg.d_model
    x = torch.from_numpy(g.standard_normal((B, S, d)))
    c = torch.from_numpy(g.standard_normal((B, S, d)))
    v_moe = TOPT.tree_map(lambda t: torch.from_numpy(
        g.standard_normal(tuple(t.shape))), moe)
    v_x = torch.from_numpy(g.standard_normal((B, S, d)))
    eps = 1e-6

    def rank(mesh):
        rules = dict(SH.rules_for(cfg, mesh), mesh=mesh, moe_a2a=True)
        fspecs = SH.param_specs(cfg, full, rules, mesh)["layers"]["moe"]
        specs = TOPT.tree_map(lambda s: s[1:], fspecs)  # one layer's
        rows = _index((B,), (rules["batch"],), mesh)[0]
        n = mesh.axes_size(rules["batch"])
        once = mesh.axis_index("model") == 0    # model ranks duplicate F_r

        def objective(p, xr):
            out, aux = MOE.apply_moe(p, xr, cfg, dispatch="auto")
            return (out * c[rows]).sum() + aux / n

        def shard(tree):
            return SH.shard_params(tree, specs, mesh)

        with SH.use_rules(rules):
            p = shard(moe)
            leaves = [t.requires_grad_() for t in TOPT.tree_leaves(p)]
            xr = x[rows].clone().requires_grad_()
            with torch.enable_grad():
                gs = torch.autograd.grad(objective(p, xr), [xr, *leaves])
            grads = TOPT.tree_from([k for k, _ in TOPT.tree_items(p)],
                                   list(gs[1:]))
            TTR.reduce_grads(grads, specs, mesh, rules)
            # each distinct shard once: a leaf (and x) replicated over an
            # axis is counted by that axis's rank 0 only
            deriv = (gs[0] * v_x[rows]).sum() if once else 0.0
            vs = shard(v_moe)
            for (_, gl), (_, vl), (_, s) in zip(TOPT.tree_items(grads),
                                                TOPT.tree_items(vs),
                                                TOPT.tree_items(specs)):
                split = SH.spec_axes(s)
                if all(mesh.axis_index(a) == 0 for a in mesh.axis_names
                       if a not in split):
                    deriv = deriv + (gl * vl).sum()
            fs = []
            for sign in (1, -1):
                q = shard(TOPT.tree_map(lambda t, u: t + sign * eps * u,
                                        moe, v_moe))
                with torch.no_grad():
                    f = objective(q, x[rows] + sign * eps * v_x[rows])
                fs.append(float(f) if once else 0.0)
        return float(deriv), fs

    out = run_mesh(shape, rank)
    deriv = sum(d for d, _ in out)
    fd = (sum(f[0] for _, f in out) - sum(f[1] for _, f in out)) / (2 * eps)
    assert abs(deriv - fd) <= 1e-6 * abs(fd), (deriv, fd)


@pytest.mark.parametrize("arch,changes", [
    ("mamba2-780m", ()), ("zamba2-7b", (("num_layers", 3),)),
    ("whisper-medium", ())], ids=["ssm", "hybrid", "audio"])
def test_accumulation_under_rules_families(arch, changes):
    """ssm, hybrid and audio: ``make_train_step_accum`` under rules on
    (2, 2) (each rank's 2 rows, whisper's with their frames, as 2
    micro-batches of 1) against the unsharded one step on the same
    unmasked batch: the loss (1e-5) and every updated shard (1e-4). Both
    run in float64 (``float64_math``) from the port's float32 draw: in
    float32 a zero-initialised bias whose gradient holds entries near
    Adam's eps (whisper's ``norm_x/bias``, |g| 2.3e-8) lands 1.8e-4 from
    the unsharded step while each float32 step is 0.7-1.0e-4 from the
    float64 one, which sharded and unsharded share to 1.5e-13."""
    tcfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    full = T.init_params(tcfg, torch.Generator().manual_seed(0), "float32")
    full = TOPT.tree_map(torch.Tensor.double, full)
    np_params = TOPT.tree_map(lambda t: t.numpy().copy(), full)
    dcfg = TDP.DataConfig(**DATA)
    ocfg = TOPT.OptimizerConfig(**OPT_KW)
    whole = TDP.synth_batch(tcfg, dcfg, 0, "cpu")
    whole["mask"] = torch.ones_like(whole["mask"])
    if tcfg.family == "audio":
        whole["frames"] = TDP.synth_frames(tcfg, dcfg, 0, "cpu").double()
    with float64_math():
        p, _, want = TTR.make_train_step(tcfg, ocfg)(
            full, TOPT.init_opt_state(full), whole)
    want_p = {k: v.numpy() for k, v in _flat(p).items()}

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        specs = SH.param_specs(tcfg, np_params, rules, mesh)
        mine = {k: SH.shard_leaf(v, SH.batch_specs(rules, True)[k], mesh)
                for k, v in whole.items()}
        q = shard_from_numpy(np_params, specs, mesh, "cpu")
        with SH.use_rules(rules):
            q, _, m = TTR.make_train_step_accum(tcfg, ocfg, accum_steps=2)(
                q, TOPT.init_opt_state(q), mine)
        where = [_index(v.shape, s, mesh) for v, (_, s) in zip(
            _flat(np_params).values(), TOPT.tree_items(specs))]
        return float(m["total_loss"]), _flat(q), where

    with float64_math():
        ranks = run_mesh((2, 2), rank)
    for loss, q, where in ranks:
        assert _rel(loss, float(want["total_loss"])) <= 1e-5
        for (k, v), idx in zip(q.items(), where):
            assert v.dtype == torch.float64
            assert _rel(v.numpy(), want_p[k][idx]) <= 1e-4, k
