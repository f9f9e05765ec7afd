"""Port parity, the MoE layer: repro_torch.models.moe against
repro.models.moe on the same seeded inputs and the same weights (JAX
init bridged through numpy), on reduced qwen2-moe (4 experts, padded to
16: ``auto`` takes the dense dispatch) and on the same config with 12
experts (padded to 16: ``auto`` takes the scatter dispatch); the arctic
dense-residual branch; and the reduced MoE engine's token streams
against the reference engine under the budget scheduler with chunked
prefill, for both dispatch paths. Tolerances: fp32 3e-5, bf16 2e-2."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import Engine
from _torch_parity import jit, one_torch_thread, specs  # noqa: F401

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
EXPERTS = {"dense": 4, "scatter": 12}   # variant -> routed experts


def _cfgs(n_experts):
    return tuple(dataclasses.replace(get("qwen2-moe-a2.7b").reduced(),
                                     num_experts=n_experts)
                 for get in (jax_config, get_config))


@functools.lru_cache(maxsize=None)
def _moe_params(variant, dtype):
    jcfg, tcfg = _cfgs(EXPERTS[variant])
    jp = jit(JM.init_moe, jcfg, jax.random.PRNGKey(0), jnp.dtype(dtype))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _x(cfg, dtype, shape=(2, 12), seed=0, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32) * scale
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["dense", "scatter"])
def test_route(variant, dtype):
    """The same experts in the same slot order; weights in x's type and
    the aux loss agree."""
    jcfg, jp, tcfg, tp = _moe_params(variant, dtype)
    jx, tx = _x(jcfg, dtype)
    jw, ji, ja = jit(JM.route, jp, jx, jcfg)
    tw, ti, ta = TM.route(tp, tx, tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tw.dtype == tx.dtype
    _close(tw, jw, TOL[dtype])
    assert abs(float(ta) - float(ja)) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["dense", "scatter"])
@pytest.mark.parametrize("variant", ["dense", "scatter"])
def test_dispatch_paths(variant, path, dtype):
    """``_moe_dense`` and ``_moe_scatter`` each against the reference's,
    on the reference's routing (both paths take any expert count)."""
    jcfg, jp, tcfg, tp = _moe_params(variant, dtype)
    jx, tx = _x(jcfg, dtype, seed=1)
    jw, ji, _ = jit(JM.route, jp, jx, jcfg)
    tw = torch.from_numpy(np.asarray(jw, np.float32)).to(tx.dtype)
    ti = torch.from_numpy(np.asarray(ji)).long()
    jfn, tfn = ((JM._moe_dense, TM._moe_dense) if path == "dense"
                else (JM._moe_scatter, TM._moe_scatter))
    want = jit(jfn, jp, jx, jw, ji, jcfg)
    got = tfn(tp, tx, tw, ti, tcfg)
    assert got.dtype == tx.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["dense", "scatter"])
def test_apply_moe(variant, dtype):
    """The whole block (routed + shared experts) under ``auto``."""
    jcfg, jp, tcfg, tp = _moe_params(variant, dtype)
    jx, tx = _x(jcfg, dtype, seed=2)
    want, ja = jit(JM.apply_moe, jp, jx, jcfg)
    got, ta = TM.apply_moe(tp, tx, tcfg)
    _close(got, want, TOL[dtype])
    assert abs(float(ta) - float(ja)) <= 1e-5


def _slot_major_spec(idx, E, cap):
    """The drop order written out token by token: slot j = 0 first, each
    token in order, an expert's next free row until ``cap``."""
    count = [0] * E
    pos = np.zeros(idx.shape, np.int64)
    keep = np.zeros(idx.shape, bool)
    for j in range(idx.shape[1]):
        for t in range(idx.shape[0]):
            e = int(idx[t, j])
            keep[t, j] = count[e] < cap
            pos[t, j] = count[e] if keep[t, j] else cap - 1
            count[e] += 1
    return pos, keep


@pytest.mark.parametrize("variant", ["dense", "scatter"])
def test_capacity_overflow(variant):
    """capacity_factor 0.5 over 128 tokens: many (token, slot) pairs are
    dropped. The port's ranks and keep masks follow the slot-major
    order, its routing equals the reference's, and the outputs (which
    the drops shape) agree."""
    jcfg, jp, tcfg, tp = _moe_params(variant, "float32")
    jx, tx = _x(jcfg, "float32", shape=(2, 64), seed=3)
    jw, ji, _ = jit(JM.route, jp, jx, jcfg)
    tw, ti, _ = TM.route(tp, tx, tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    E = tcfg.padded_experts(TM.EXPERT_AXIS_PAD)
    cap = TM.capacity(128, tcfg, 0.5)
    idx = ti.reshape(128, -1)
    positions, keeps = TM._dispatch_plan(idx, E, cap)
    want_pos, want_keep = _slot_major_spec(idx.numpy(), E, cap)
    np.testing.assert_array_equal(torch.stack(keeps, 1).numpy(), want_keep)
    np.testing.assert_array_equal(torch.stack(positions, 1).numpy(),
                                  want_pos)
    assert 0 < want_keep.sum() < want_keep.size      # drops happened
    want = jit(JM._moe_scatter, jp, jx, jw, ji, jcfg, 0.5)
    got = TM._moe_scatter(tp, tx, tw, ti, tcfg, 0.5)
    _close(got, want, TOL["float32"])


def test_padding_experts_never_selected():
    """12 experts padded to 16: even a router that favours the padding
    columns overwhelmingly routes only to real experts."""
    _, _, tcfg, tp = _moe_params("scatter", "float32")
    p = dict(tp, router=tp["router"].clone())
    p["router"][:, tcfg.num_experts:] = 1e4
    _, tx = _x(tcfg, "float32", shape=(4, 64), seed=4, scale=10.0)
    for params in (tp, p):
        _, idx, _ = TM.route(params, tx, tcfg)
        assert int(idx.max()) < tcfg.num_experts
        assert (idx.sort(-1).values.diff(dim=-1) > 0).all()  # distinct


def test_arctic_dense_residual():
    """arctic's reduced config: top-2 of 4 experts and a dense residual
    SwiGLU beside them (no shared experts)."""
    jcfg = jax_config("arctic-480b").reduced()
    tcfg = get_config("arctic-480b").reduced()
    jp = jit(JM.init_moe, jcfg, jax.random.PRNGKey(1), jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert "residual" in tp and "shared" not in tp
    jx, tx = _x(jcfg, "float32", seed=5)
    want, ja = jit(JM.apply_moe, jp, jx, jcfg)
    got, ta = TM.apply_moe(tp, tx, tcfg)
    _close(got, want, TOL["float32"])
    assert abs(float(ta) - float(ja)) <= 1e-5


def test_expert_parallel_raises_a10():
    _, _, tcfg, tp = _moe_params("scatter", "float32")
    _, tx = _x(tcfg, "float32")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        TM.apply_moe(tp, tx, tcfg, dispatch="expert_parallel")


def test_port_init_moe_tree_and_bridge():
    """The port's init gives the reference's MoE tree (keys, shapes, an
    fp32 router beside bf16 experts); a bf16 reference tree bridges key
    for key, its router staying fp32 when no dtype is passed."""
    jcfg, tcfg = _cfgs(12)
    jp = jit(JT.init_params, jcfg, jax.random.PRNGKey(0), "bfloat16")
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "bfloat16")
    bridged = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for tree in (tp, bridged):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert ({jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
                 for k, v in flat}
                == {jax.tree_util.keystr(k): (v.shape, v.dtype.name)
                    for k, v in jflat})
    for tree in (tp, bridged):
        moe = tree["layers"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["w_gate"].dtype == torch.bfloat16
        assert "mlp" not in tree["layers"]
    np.testing.assert_array_equal(
        bridged["layers"]["moe"]["router"].numpy(),
        np.asarray(jp["layers"]["moe"]["router"]))


# --------------------------------------------------------------- the engine
def _prompts(sizes, seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=s).astype(np.int32) for s in sizes]


@functools.lru_cache(maxsize=None)
def _engine_params(n_experts):
    jcfg, tcfg = _cfgs(n_experts)
    jp = jit(JT.init_params, jcfg, jax.random.PRNGKey(0), "float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("variant", ["dense", "scatter"])
def test_engine_streams_identical(variant):
    """Prompts 40/72/24 and one sharing a prefix, budget 24, block 8:
    chunked prefill (its buckets' padding tokens dispatched with the
    real ones, as in the reference), prefix hits, one sampled row; the
    port's streams equal the reference engine's under the same budget
    scheduler."""
    jcfg, jp, tcfg, tp = _engine_params(EXPERTS[variant])
    base = _prompts([40, 72, 24], seed=1, vocab=tcfg.vocab_size)
    prompts = base + [np.concatenate([base[0][:24], base[2]])]
    rows = [(i, p, 5, 0.8 if i == 1 else 0.0, 8 if i == 1 else 0, 100 + i)
            for i, p in enumerate(prompts)]
    kw = dict(max_batch=3, max_len=128, block_size=8, token_budget=24,
              scheduler="budget")
    out = {}
    for side, eng in (
            ("jax", JaxEngine(jcfg, jp, cache_kind="paged", **kw)),
            ("port", Engine(tcfg, tp, device="cpu", **kw))):
        for spec in specs(rows, jax_side=side == "jax"):
            eng.submit(spec)
        with jax.threefry_partitionable(True):
            out[side] = {r.rid: list(r.generated)
                         for r in eng.run_until_done()}
    assert out["port"] == out["jax"] and len(out["port"]) == 4
    assert eng.prefix_stats()["hits"] > 0
    assert eng.pstate.blocks_in_use() == 0
