"""Port parity, the train step: repro_torch.training.train (and the
train-mode forward of repro_torch.models.transformer) against
repro.training.train on the same numpy-seeded batches and bridged
weights, for every family: dense, vlm, moe (the dense dispatch, and the
scatter dispatch at 12 experts), ssm, hybrid, MLA and audio.
Tolerances: fp32 loss 1e-5 relative, each gradient leaf and each
updated parameter 1e-4 relative L2; bf16 (dense) 2e-2. Also: ``remat``
gives the same gradients as no remat, and a stacked leaf's gradient is
stacked once. The sharded step is tests/test_torch_sharded_train.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import pipeline as JDP
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro.training import train as JTR
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TDP
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as TOPT
from repro_torch.training import train as TTR
from _torch_parity import jit, one_torch_thread  # noqa: F401

ARCH = {"dense": "tinyllama-1.1b", "vlm": "chameleon-34b",
        "moe": "qwen2-moe-a2.7b", "ssm": "mamba2-780m",
        "hybrid": "zamba2-7b", "mla": "minicpm3-4b",
        "audio": "whisper-medium"}
#: 12 experts (padded to 16): "auto" takes the scatter dispatch, whose
#: backward the 4-expert reduced config (the dense dispatch) never runs
SCATTER_EXPERTS = 12
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KEY = jax.random.PRNGKey(0)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(jnp.asarray(v, jnp.float32))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree):
    return {"/".join(p): v.detach().float().numpy()
            for p, v in TOPT.tree_items(tree)}


def _assert_trees_close(got, want, tol, what):
    got, want = _port_flat(got), _jax_flat(want)
    assert set(got) == set(want), what
    for k, w in want.items():
        assert _rel(got[k], w) <= tol, (what, k, _rel(got[k], w))


@functools.lru_cache(maxsize=None)
def _case(family, dtype="float32", batch=2, seq=32):
    """(jcfg, jax params, tcfg, port params, jax batch, port batch): the
    reduced config's reference weights (bf16 narrowed from the fp32 draw,
    as the reference's bf16 init does) bridged to the port, and one
    synthetic batch (audio adds numpy-seeded frames)."""
    arch = ARCH["moe" if family == "moe-scatter" else family]
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if family == "moe-scatter":
        jcfg, tcfg = (dataclasses.replace(c, num_experts=SCATTER_EXPERTS)
                      for c in (jcfg, tcfg))
    jp = jit(JT.init_params, jcfg, KEY, "float32")
    if dtype != "float32":
        jp = jax.tree_util.tree_map(lambda a: a.astype(dtype), jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb = JDP.synth_batch(jcfg, JDP.DataConfig(seq_len=seq, global_batch=batch),
                         0)
    tb = TDP.synth_batch(tcfg, TDP.DataConfig(seq_len=seq, global_batch=batch),
                         0, "cpu")
    if jcfg.family == "audio":
        frames = np.random.default_rng(0).standard_normal(
            (batch, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(frames), torch.from_numpy(
            frames)
    return jcfg, jp, tcfg, tp, jb, tb


@functools.lru_cache(maxsize=None)
def _reference_grads(family, dtype="float32"):
    """One reference ``value_and_grad`` of the loss per (family, dtype),
    shared by the tests that compare against it."""
    jcfg, jp, _, _, jb, _ = _case(family, dtype)
    fn = jax.jit(jax.value_and_grad(JTR.make_loss_fn(jcfg), has_aux=True))
    return fn(jp, jb)


@pytest.mark.parametrize("family", [*ARCH, "moe-scatter"])
def test_loss_and_grads_match_reference(family):
    (jtotal, jparts), jgrads = _reference_grads(family)
    _, _, tcfg, tp, _, tb = _case(family)
    (total, parts), grads = TTR.value_and_grad(TTR.make_loss_fn(tcfg), tp, tb)
    for got, want in ((total, jtotal), (parts["loss"], jparts["loss"]),
                      (parts["aux_loss"], jparts["aux_loss"])):
        assert abs(float(got) - float(want)) <= 1e-5 * max(abs(float(want)),
                                                           1e-30)
    if family.startswith("moe"):
        assert float(parts["aux_loss"]) > 0
    _assert_trees_close(grads, jgrads, TOL["float32"], family)
    for (_, g), (_, p) in zip(TOPT.tree_items(grads), TOPT.tree_items(tp)):
        assert g.dtype == p.dtype and g.shape == p.shape


def test_bf16_dense_loss_and_grads_match_reference():
    """bf16 weights: the gradients come out bf16, as the reference's, and
    within bf16's 2e-2 (``layers._silu``'s backward is JAX's VJP op for
    op)."""
    (jtotal, _), jgrads = _reference_grads("dense", "bfloat16")
    _, _, tcfg, tp, _, tb = _case("dense", "bfloat16")
    (total, _), grads = TTR.value_and_grad(TTR.make_loss_fn(tcfg), tp, tb)
    assert abs(float(total) - float(jtotal)) <= 2e-2 * abs(float(jtotal))
    assert {g.dtype for g in TOPT.tree_leaves(grads)} == {torch.bfloat16}
    _assert_trees_close(grads, jgrads, TOL["bfloat16"], "dense bf16")


def test_silu_backward_is_jax_vjp_bf16():
    """``layers._silu``'s gradient in bf16 equals ``jax.vjp`` of
    ``jax.nn.silu`` bit for bit (plain autograd through its ops differs
    in about half of the elements)."""
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 4).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    want = jax.jit(lambda x, g: jax.vjp(jax.nn.silu, x)[1](g)[0])(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    (got,) = torch.autograd.grad(TL._silu(tx), tx, torch.from_numpy(g).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _opt_cfgs(**kw):
    kw = dict(dict(lr=3e-3, warmup_steps=2, total_steps=50), **kw)
    return JOPT.OptimizerConfig(**kw), TOPT.OptimizerConfig(**kw)


def test_params_after_steps_match_reference():
    """Three train steps (dense) from the same weights and optimizer state
    (the reference's, bridged by ``opt_state_from_numpy``): params after
    1 and 3 steps, and each step's loss, lr and grad norm."""
    jcfg, jp, tcfg, tp, _, _ = _case("dense")
    jocfg, tocfg = _opt_cfgs()
    jstep = jax.jit(JTR.make_train_step(jcfg, jocfg))
    tstep = TTR.make_train_step(tcfg, tocfg)
    jopt = JOPT.init_opt_state(jp)
    tparams = TOPT.tree_map(torch.clone, tp)
    topt = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, jopt),
                                "cpu")
    for i in range(3):
        jb = JDP.synth_batch(jcfg, JDP.DataConfig(seq_len=32, global_batch=2),
                             i)
        tb = TDP.synth_batch(tcfg, TDP.DataConfig(seq_len=32, global_batch=2),
                             i, "cpu")
        jp, jopt, jm = jstep(jp, jopt, jb)
        tparams, topt, tm = tstep(tparams, topt, tb)
        for k in ("loss", "total_loss", "lr", "grad_norm"):
            assert _rel(float(tm[k]), float(jm[k])) <= 1e-5, (i, k)
        if i in (0, 2):
            _assert_trees_close(tparams, jp, TOL["float32"], f"step {i + 1}")
    assert int(topt["step"]) == 3
    _assert_trees_close(topt["mu"], jopt["mu"], TOL["float32"], "mu")


def test_accum_step_matches_reference():
    """``make_train_step_accum`` (2 micro-batches of 2 rows, moe with its
    aux loss) against the reference's: params after the step, the total
    loss and the grad norm."""
    jcfg, jp, tcfg, tp, jb, tb = _case("moe", batch=4)
    jocfg, tocfg = _opt_cfgs()
    jparams, jopt, jm = jax.jit(JTR.make_train_step_accum(
        jcfg, jocfg, accum_steps=2))(jp, JOPT.init_opt_state(jp), jb)
    tparams, _, tm = TTR.make_train_step_accum(tcfg, tocfg, accum_steps=2)(
        TOPT.tree_map(torch.clone, tp), TOPT.init_opt_state(tp), tb)
    assert set(tm) == set(jm)
    for k in jm:
        assert _rel(float(tm[k]), float(jm[k])) <= 1e-5, k
    _assert_trees_close(tparams, jparams, TOL["float32"], "accum")


@pytest.mark.parametrize("family", list(ARCH))
def test_remat_gives_equal_gradients(family):
    """``forward(remat=True)`` (each layer's body, a hybrid's blocks,
    checkpointed) against no remat: the same loss and gradients."""
    _, _, tcfg, tp, _, tb = _case(family)
    out = [TTR.value_and_grad(TTR.make_loss_fn(tcfg, remat=r), tp, tb)
           for r in (False, True)]
    (t0, _), g0 = out[0]
    (t1, _), g1 = out[1]
    assert torch.equal(t0, t1)
    for (path, a), (_, b) in zip(TOPT.tree_items(g0), TOPT.tree_items(g1)):
        assert torch.equal(a, b), path


def _leaf_consumers(root):
    """id(leaf) -> names of the autograd nodes that read it directly."""
    seen, stack, out = set(), [root], {}
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if hasattr(nxt, "variable"):
                out.setdefault(id(nxt.variable), []).append(node.name())
            else:
                stack.append(nxt)
    return out


@pytest.mark.parametrize("family", ["dense", "hybrid", "audio"])
def test_stacked_leaf_gradient_stacked_once(family):
    """In train mode every stacked ``[L, ...]`` leaf (the hybrid's
    ``[nb, every, ...]`` blocks and its tail, the audio encoder's layers)
    is read by ONE unbind, whose backward stacks its gradient once, not
    by a select per layer (each of which writes a zero tensor the size of
    the whole stack in the backward)."""
    _, _, tcfg, tp, _, tb = _case(family)
    paths = [p for p, _ in TOPT.tree_items(tp)]
    leaves = [t.detach().requires_grad_() for t in TOPT.tree_leaves(tp)]
    params = TOPT.tree_from(paths, leaves)
    logits, _, _ = TT.forward(params, tcfg, tb["tokens"], mode="train",
                              encoder_input=tb.get("frames"))
    consumers = _leaf_consumers(logits.sum().grad_fn)
    stacked = [(p, t) for p, t in zip(paths, leaves)
               if p[0] in ("layers", "blocks", "tail")
               or p[:2] == ("encoder", "layers")]
    assert stacked
    for path, t in stacked:
        assert consumers[id(t)] == ["UnbindBackward0"], path


def test_kernel_guard_refuses_autograd():
    """No kernel has a backward: the wrappers' CUDA branch calls
    ``build.check_no_grad``, which raises on an input that requires grad
    under grad mode (``chip_smoke.py`` phase 14g calls each wrapper so on
    the card) and lets the same call through under ``torch.no_grad()``."""
    from repro_torch.kernels import build
    w = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        build.check_no_grad("kernel", torch.zeros(4), w)
    with torch.no_grad():
        build.check_no_grad("kernel", torch.zeros(4), w)
    build.check_no_grad("kernel", torch.zeros(4), w.detach())


def test_train_mode_takes_no_cache():
    """A train call's forward never writes a cache: passing one raises."""
    _, _, tcfg, tp, _, tb = _case("dense")
    cache = TT.init_cache(tcfg, 2, 32, "float32", "cpu")
    with pytest.raises(ValueError, match="no cache"):
        TT.forward(tp, tcfg, tb["tokens"], cache=cache, mode="train")
