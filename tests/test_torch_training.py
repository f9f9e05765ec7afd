"""Port parity, the training substrate: repro_torch.training.optimizer,
repro_torch.training.checkpoint, repro_torch.data.pipeline and
repro_torch.launch.train against the JAX package on the same inputs.
Tolerances: ``lr_at`` within 1 float32 ulp, ``apply_updates`` 1e-6
relative L2 per leaf, ``synth_batch`` and checkpoints bit-equal, the CPU
driver's final loss 1e-4 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import pipeline as JDP
from repro.models import transformer as JT
from repro.training import checkpoint as JCK
from repro.training import optimizer as JOPT
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TDP
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint as TCK
from repro_torch.training import optimizer as TOPT
from _torch_parity import jit, one_torch_thread  # noqa: F401


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(t):
    """A port tensor as numpy, bf16 as float32 (exact)."""
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.detach().numpy()


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree):
    return {"/".join(path): v for path, v in TOPT.tree_items(tree)}


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, warmup_steps=100, total_steps=10_000, min_lr_ratio=0.1),
    dict(lr=3e-3, warmup_steps=20, total_steps=200, min_lr_ratio=0.1),
], ids=["warmup100", "warmup20"])
def test_lr_at_within_one_ulp(kw):
    """Steps 0-10000 (past total_steps for the second schedule), each
    within one float32 ulp of the reference's; the float32 quirk at the
    end of the warmup is kept (float32's 1e-3, above cfg.lr)."""
    steps = np.arange(0, 10_001, dtype=np.int32)
    jcfg, tcfg = JOPT.OptimizerConfig(**kw), TOPT.OptimizerConfig(**kw)
    want = np.asarray(jax.jit(lambda s: JOPT.lr_at(jcfg, s))(steps))
    got = TOPT.lr_at(tcfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, (ulps.max(), int(steps[ulps.argmax()]))
    end = kw["warmup_steps"]
    assert float(TOPT.lr_at(tcfg, end)) == float(JOPT.lr_at(jcfg, end)) \
        == float(np.float32(kw["lr"]))


def _opt_tree(rng, scale=1.0):
    """A params-shaped tree: a stacked norm [L, d], stacked matrices, an
    embedding, vectors."""
    shapes = {"embed": (16, 8), "final_norm": {"scale": (8,)},
              "layers": {"norm1": {"scale": (2, 8)},
                         "attn": {"wq": (2, 8, 2, 4)}}, "bias": (8,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return draw(shapes)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
def test_apply_updates_matches_reference(clip, moments):
    """Three AdamW steps from the same params, grads and state: params,
    both moments (bf16 ones come out float32, as the reference's), the
    step, lr and grad norm within 1e-6."""
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng, 3.0) for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    jcfg, tcfg = JOPT.OptimizerConfig(**kw), TOPT.OptimizerConfig(**kw)
    jstep = jax.jit(JOPT.apply_updates, static_argnums=0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = JOPT.init_opt_state(jp, moments)
    tp = params_from_numpy(params, "cpu")
    ts = TOPT.init_opt_state(tp, moments)
    assert ts["mu"]["embed"].dtype == getattr(torch, moments)
    for g in grads:
        jp, js, jm = jstep(jcfg, jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts, tm = TOPT.apply_updates(tcfg, tp, params_from_numpy(g, "cpu"),
                                        ts)
        for name, jt, tt in (("params", jp, tp), ("mu", js["mu"], ts["mu"]),
                             ("nu", js["nu"], ts["nu"])):
            want, got = _jax_flat(jt), _port_flat(tt)
            assert set(want) == set(got)
            for k, w in want.items():
                assert got[k].dtype == getattr(torch, str(w.dtype)), (name, k)
                assert _rel(_np(got[k]), w) <= 1e-6, (name, k)
        assert int(ts["step"]) == int(js["step"])
        for k in ("lr", "grad_norm"):
            assert _rel(float(tm[k]), float(jm[k])) <= 1e-6, k


def test_decay_mask_matches_reference():
    """Every 2D+ leaf decays, the stacked norm scales [L, d] included (a
    reference quirk the port keeps); the hybrid's [nb, every, ...]
    blocks too."""
    for arch in ("tinyllama-1.1b", "zamba2-7b"):
        jcfg = jax_config(arch).reduced()
        jp = jax.eval_shape(lambda: JT.init_params(
            jcfg, jax.random.PRNGKey(0), "float32"))
        want = _jax_flat(JOPT._decay_mask(jp))
        tp = TT.init_params(get_config(arch).reduced(),
                            torch.Generator().manual_seed(0), "float32")
        got = _port_flat(TOPT._decay_mask(tp))
        assert {k: bool(v) for k, v in want.items()} == got, arch
    assert got["blocks/norm/scale"] and not got["final_norm/scale"]


@pytest.mark.parametrize("arch,seq,batch,seed,step", [
    ("tinyllama-1.1b", 64, 2, 1, 0),
    ("tinyllama-1.1b", 32, 4, 0, 3),
    ("whisper-medium", 128, 2, 7, 11),
])
def test_synth_batch_bit_identical(arch, seq, batch, seed, step):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jd = JDP.DataConfig(seq_len=seq, global_batch=batch, seed=seed)
    td = TDP.DataConfig(seq_len=seq, global_batch=batch, seed=seed)
    want = JDP.synth_batch(jcfg, jd, step)
    got = TDP.synth_batch(tcfg, td, step, "cpu")
    assert set(got) == set(want) == {"tokens", "labels", "mask"}
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w)
    it = TDP.batches(tcfg, td, num_steps=step + 1, device="cpu")
    last = list(it)[-1]
    np.testing.assert_array_equal(last["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


def test_pipeline_needs_cuda_without_a_device(monkeypatch):
    """The pipeline's entry points put their tensors on the card unless
    the caller names a device: without CUDA they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, dcfg = get_config("tinyllama-1.1b").reduced(), TDP.DataConfig(
        seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDP.synth_batch(cfg, dcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDP.synth_frames(get_config("whisper-medium").reduced(), dcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(TDP.batches(cfg, dcfg, 1))
    assert TDP.synth_batch(cfg, dcfg, 0, "cpu")["tokens"].device.type == "cpu"


def _ckpt_trees(dtype):
    """The same tree in both packages: reduced mamba2 weights (fp32, or
    narrowed to bf16) and the reference's fresh optimizer state (an int32
    scalar step among them)."""
    jcfg = jax_config("mamba2-780m").reduced()
    jp = jit(JT.init_params, jcfg, jax.random.PRNGKey(0), "float32")
    jp = jax.tree_util.tree_map(lambda a: a.astype(dtype), jp)
    jtree = {"params": jp, "opt": JOPT.init_opt_state(jp)}
    host = jax.tree_util.tree_map(np.asarray, jtree)
    ttree = {"params": params_from_numpy(host["params"], "cpu"),
             "opt": opt_state_from_numpy(host["opt"], "cpu")}
    return jtree, ttree


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_across_packages(dtype, tmp_path):
    """Both packages write the same bytes for the same tree; each loads
    the other's file bit for bit (``like=`` restores structure, dtypes
    and device; without it a flat dict)."""
    jtree, ttree = _ckpt_trees(dtype)
    meta = {"arch": "mamba2-780m", "steps": 3}
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    JCK.save(jpath, jtree, meta)
    TCK.save(tpath, ttree, meta)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    assert not (tmp_path / "t.ckpt.tmp").exists()

    # port file -> reference
    restored, got_meta = JCK.load(tpath, like=jtree)
    assert got_meta == meta
    for k, v in _jax_flat(restored).items():
        assert v.dtype == _jax_flat(jtree)[k].dtype, k
        np.testing.assert_array_equal(_bits(v), _bits(_jax_flat(jtree)[k]))

    # reference file -> port
    restored, got_meta = TCK.load(jpath, like=ttree)
    assert got_meta == meta
    want = _port_flat(ttree)
    got = _port_flat(restored)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and v.device == want[k].device, k
        np.testing.assert_array_equal(_tbits(v), _tbits(want[k]))
    flat, _ = TCK.load(jpath)
    assert flat["params/embed"].dtype == getattr(torch, dtype)
    assert flat["opt/step"].dtype == torch.int32 and flat["opt/step"].ndim == 0


def test_checkpoint_missing_key(tmp_path):
    _, ttree = _ckpt_trees("float32")
    path = str(tmp_path / "p.ckpt")
    TCK.save(path, ttree["params"])
    with pytest.raises(KeyError, match="missing"):
        TCK.load(path, like=ttree)


def test_train_driver_matches_reference(monkeypatch, tmp_path):
    """``launch.train.main`` on the CPU against the reference's ``main``
    with the same flags and the reference's weights (bridged in place of
    the port's own draw): the final loss within 1e-4; its ``--ckpt``
    file holds the reference's keys."""
    from repro.launch.train import main as jax_main
    from repro_torch.launch import train as TLT

    argv = ["--arch", "tinyllama-1.1b", "--reduce", "--steps", "6",
            "--batch", "2", "--seq", "32", "--log-every", "5"]
    jcfg = jax_config("tinyllama-1.1b").reduced()

    def bridged(cfg, gen, dtype):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            get_config("tinyllama-1.1b").reduced())
        jp = jit(JT.init_params, jcfg, jax.random.PRNGKey(0), dtype)
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 gen.device)

    monkeypatch.setattr(TLT.T, "init_params", bridged)
    want = jax_main(argv)
    ckpt = str(tmp_path / "final.ckpt")
    got = TLT.main(["--device", "cpu", "--ckpt", ckpt] + argv)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    flat, meta = JCK.load(ckpt)
    assert meta == {"steps": 6, "arch": jcfg.name}
    assert set(flat) == set(_jax_flat(jax.eval_shape(
        lambda: JT.init_params(jcfg, jax.random.PRNGKey(0), "float32"))))


def test_train_driver_needs_cuda_or_cpu_flag(monkeypatch):
    from repro_torch.launch import train as TLT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TLT.main(["--reduce", "--steps", "1"])
