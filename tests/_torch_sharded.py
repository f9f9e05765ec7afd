"""Helpers of the port's sharded-family tests (``test_torch_ssm_parallel``,
``test_torch_audio_parallel``): the reference's UNSHARDED serving stream
and train step under one jit each, and one thread-rank's counterparts
under sharding rules, on weights drawn by the reference's
``init_params`` and bridged through numpy."""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro.training import train as JTR
from repro_torch.bridge import shard_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TDP
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.training import optimizer as TOPT
from repro_torch.training import train as TTR
from _torch_mesh import rows

KEY = jax.random.PRNGKey(0)
OPT_KW = dict(lr=3e-3, warmup_steps=2, total_steps=50, clip_norm=0.5)


def rel(got, want):
    """Relative L2 distance, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@contextlib.contextmanager
def float64_math():
    """Inside, ``Tensor.float()`` leaves a float64 tensor float64. The port
    computes its norms, scans and optimizer moments through ``.float()``;
    a float64 run under this context rounds nowhere to float32, so a
    sharded step and the unsharded one differ by float64 rounding alone,
    where in float32 Adam's first update can grow rounding past 1e-4 (an
    entry of a gradient near eps moves u = m / (sqrt(v) + eps) by as
    much as the entry's own rounding)."""
    cast = torch.Tensor.float

    def keep(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else cast(self, *args, **kwargs)

    torch.Tensor.float = keep
    try:
        yield
    finally:
        torch.Tensor.float = cast


def flat(tree):
    """'/'-joined path -> leaf, of a nested dict (the port's or JAX's)."""
    return {"/".join(p): v for p, v in TOPT.tree_items(tree)}


def shard_index(shape, spec, mesh):
    """This rank's slices of a leaf of ``shape`` under ``spec``."""
    out = []
    for i, n in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        k, j = mesh.axes_size(axes), mesh.axes_index(axes)
        out.append(slice(j * (n // k), (j + 1) * (n // k)))
    return tuple(out)


@functools.cache
def _draw(arch, changes):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **dict(changes))
    tcfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    jp = jax.jit(lambda: JT.init_params(jcfg, KEY, "float32"))()
    return jcfg, jax.tree_util.tree_map(np.asarray, jp), tcfg


#: the leaves the reference's ``init_params`` keeps in fp32 at any type
FP32_LEAVES = ("A_log", "D", "dt_bias")


@functools.cache
def pair(arch, changes=(), dtype="float32"):
    """(jax cfg, numpy weights, port cfg): ``arch.reduced()`` with
    ``changes``; the weights are the reference's ``init_params`` fp32
    draw, each leaf cast to the type the reference's ``dtype`` draw gives
    it (bf16 weights with fp32 ``A_log``, ``D`` and ``dt_bias``)."""
    jcfg, np_params, tcfg = _draw(arch, changes)
    cast = jnp.dtype(dtype)
    return jcfg, jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in FP32_LEAVES
        else np.asarray(jnp.asarray(a).astype(cast)), np_params), tcfg


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def frames(cfg, B, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32)


def ref_stream(jcfg, np_params, toks, M, steps, ext=None, enc=None,
               window=None):
    """The reference's prefill of ``toks`` over a fresh cache of ``M``
    slots, ``steps`` greedy decode steps and, given ``ext`` [B, n], an
    n-token extension (decode mode, from the cache's states), under one
    jit: (logits [calls, B, V] of each call, greedy tokens [B, steps +
    1]). ``enc``: an audio config's frames; ``window`` every call's
    attention window (a ring where ``M`` is shorter than the stream)."""
    B, S = toks.shape
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    dtype = str(np_params["embed"].dtype)

    def run(p, enc):
        cache = JT.init_cache(jcfg, B, M, dtype)
        lg, cache, _ = JT.forward(p, jcfg, toks, cache=cache, mode="prefill",
                                  encoder_input=enc, window=window)
        first = jnp.argmax(lg[:, :jcfg.vocab_size], -1)

        def step(carry, t):
            cache, tok = carry
            pos = jnp.full((B, 1), S + t, jnp.int32)
            lg, cache, _ = JT.forward(p, jcfg, tok[:, None].astype(jnp.int32),
                                      positions=pos, cache=cache,
                                      mode="decode", window=window)
            nxt = jnp.argmax(lg[:, :jcfg.vocab_size], -1)
            return (cache, nxt), (lg, nxt)

        (cache, _), (lgs, nxt) = jax.lax.scan(step, (cache, first),
                                              jnp.arange(steps))
        out = [lg[None], lgs]
        if ext is not None:
            n = ext.shape[1]
            pos = (S + steps + jnp.arange(n, dtype=jnp.int32))[None]
            lg, _, _ = JT.forward(p, jcfg, ext, positions=jnp.broadcast_to(
                pos, (B, n)), cache=cache, mode="decode", window=window)
            out.append(lg[None])
        return (jnp.concatenate(out).astype(jnp.float32),
                jnp.concatenate([first[:, None], nxt.T], 1))

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(jp, enc))


def port_stream(tcfg, np_params, toks, M, steps, rules, mesh, ext=None,
                enc=None, impl="gather", forced=None, window=None,
                ext_colls=None):
    """This rank's counterpart of ``ref_stream`` under ``rules`` (its
    shard of the weights and the cache, its rows of the tokens, the
    extension and the frames): (its logits [calls, b, V] as float32, its
    greedy tokens [b, steps + 1], the collectives of each decode step).
    ``impl="kernel"`` takes both kernel routes (their plain versions on
    the CPU). ``forced`` [B, steps + 1]: the tokens each decode step is
    fed (the reference's), in place of this rank's own greedy ones.
    ``window``: every call's attention window; ``ext_colls``: a list
    that takes the extension's collectives."""
    specs = SH.param_specs(tcfg, np_params, rules, mesh)
    p = shard_from_numpy(np_params, specs, mesh, "cpu")
    B = toks.shape[0]
    sl = rows(mesh, rules, B)
    mine = torch.from_numpy(toks[sl]).long()
    b, S = mine.shape
    dtype = str(p["embed"].dtype).replace("torch.", "")
    cache = T.init_cache_shard(tcfg, B, M, rules, mesh, dtype, "cpu")
    kw = dict(attn_impl=impl, window=window,
              ssd_impl="kernel" if impl == "kernel" else "chunked")
    outs, colls = [], []
    with SH.use_rules(rules):
        lg, _, _ = T.forward(p, tcfg, mine, cache=cache, mode="prefill",
                             encoder_input=None if enc is None
                             else torch.from_numpy(enc[sl]), **kw)
        outs.append(lg)
        nxt = [lg[:, :tcfg.vocab_size].argmax(-1)]
        for t in range(steps):
            before = dict(mesh.collectives)
            pos = torch.full((b, 1), S + t, dtype=torch.int32)
            tok = nxt[-1] if forced is None else torch.tensor(
                forced[sl, t]).long()
            lg, _, _ = T.forward(p, tcfg, tok[:, None], positions=pos,
                                 cache=cache, mode="decode", **kw)
            colls.append({k: v - before.get(k, 0)
                          for k, v in mesh.collectives.items()
                          if v - before.get(k, 0)})
            outs.append(lg)
            nxt.append(lg[:, :tcfg.vocab_size].argmax(-1))
        if ext is not None:
            n = ext.shape[1]
            pos = (S + steps + torch.arange(n, dtype=torch.int32)).expand(b, n)
            before = dict(mesh.collectives)
            lg, _, _ = T.forward(p, tcfg, torch.from_numpy(ext[sl]).long(),
                                 positions=pos, cache=cache, mode="decode",
                                 **kw)
            if ext_colls is not None:
                ext_colls.append({k: v - before.get(k, 0)
                                  for k, v in mesh.collectives.items()
                                  if v - before.get(k, 0)})
            outs.append(lg)
    return (torch.stack(outs).float().numpy(), torch.stack(nxt, 1).numpy(),
            colls)


def global_batch(tcfg, dcfg):
    """The train step's global batch 0 as numpy (``synth_batch``, and an
    audio config's ``synth_frames``)."""
    b = TDP.synth_batch(tcfg, dcfg, 0, "cpu")
    if tcfg.family == "audio":
        b["frames"] = TDP.synth_frames(tcfg, dcfg, 0, "cpu")
    return {k: v.numpy() for k, v in b.items()}


def ref_train(jcfg, np_params, batch):
    """The reference's unsharded loss, gradient and one train step on the
    whole batch, under one jit: {"total", "loss", "grads", "params",
    "mu", "nu"} (the trees flat; the moments after the step)."""
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jocfg = JOPT.OptimizerConfig(**OPT_KW)

    def run(p, b):   # make_train_step's body, its gradients kept
        (total, parts), grads = jax.value_and_grad(
            JTR.make_loss_fn(jcfg), has_aux=True)(p, b)
        new, state, _ = JOPT.apply_updates(jocfg, p, grads,
                                           JOPT.init_opt_state(p))
        return total, parts["loss"], grads, new, state["mu"], state["nu"]

    total, loss, grads, new, mu, nu = jax.tree_util.tree_map(
        np.asarray, jax.jit(run)(jp, jb))
    return {"total": float(total), "loss": float(loss), "grads": flat(grads),
            "params": flat(new), "mu": flat(mu), "nu": flat(nu)}


def rank_train(tcfg, np_params, dcfg, mesh, rules):
    """This rank's loss parts, gradient shards (after ``reduce_grads``)
    and updated params after one train step, on its rows of batch 0
    (``sharded_batches``, frames for audio), each leaf with its slice of
    the global leaf."""
    specs = SH.param_specs(tcfg, np_params, rules, mesh)
    batch = next(TDP.sharded_batches(
        tcfg, dcfg, mesh, SH.batch_specs(rules)["tokens"], 1,
        frames=tcfg.family == "audio"))
    p = shard_from_numpy(np_params, specs, mesh, "cpu")
    with SH.use_rules(rules):
        (total, parts), grads = TTR.value_and_grad(TTR.make_loss_fn(tcfg),
                                                   p, batch)
        TTR.reduce_grads(grads, *TTR.rank_specs(tcfg, rules, p)[::-1],
                         rules)
        new, _, metrics = TTR.make_train_step(
            tcfg, TOPT.OptimizerConfig(**OPT_KW))(
                p, TOPT.init_opt_state(p), batch)
    where = {k: shard_index(v.shape, s, mesh)
             for (k, v), (_, s) in zip(flat(np_params).items(),
                                       TOPT.tree_items(specs))}
    return {"total": float(total), "loss": float(parts["loss"]),
            "step_total": float(metrics["total_loss"]),
            "grads": {k: v.numpy() for k, v in flat(grads).items()},
            "params": {k: v.numpy() for k, v in flat(new).items()},
            "where": where}


def train_errors(r, ref):
    """(loss errors, per-leaf gradient errors, per-leaf param errors) of
    one rank's ``rank_train`` against ``ref_train``."""
    losses = [rel(r["total"], ref["total"]), rel(r["loss"], ref["loss"]),
              rel(r["step_total"], ref["total"])]
    grads = {k: rel(r["grads"][k], ref["grads"][k][i])
             for k, i in r["where"].items()}
    params = {k: rel(r["params"][k], ref["params"][k][i])
              for k, i in r["where"].items()}
    return losses, grads, params


def per_step_collectives(cfg, mesh, long=False):
    """The collectives of one decode step from the design: with a model
    axis, the vocab-split embedding's psum and logits' all-gather, two
    psums a Mamba2 layer (the gated norm's sum of squares and
    ``out_proj``), two a dense layer or shared-block application (``wo``,
    ``w_down``), three an audio decoder layer (self and cross ``wo``,
    ``w_down``); under ``long_context_rules`` with a data axis (``long``),
    flash-decoding's pmax and two psums an attention layer besides."""
    attn = (cfg.num_layers // cfg.hybrid_attn_every
            if cfg.family == "hybrid" else
            cfg.num_layers if cfg.family in ("dense", "audio") else 0)
    mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    out = {}
    if mesh.axis_size("model") > 1:
        per_attn = 3 if cfg.family == "audio" else 2
        out = {"all-reduce": 1 + 2 * mamba + per_attn * attn,
               "all-gather": 1}
    if long and attn and mesh.axis_size("data") > 1:
        out["all-reduce"] = out.get("all-reduce", 0) + 3 * attn
    return out
