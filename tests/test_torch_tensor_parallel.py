"""Port parity, the sharded serving step: the port's ``forward`` under
sharding rules, every rank a thread with its shard of the weights
(``shard_from_numpy`` of one seeded fp32 draw, which the reference takes
whole), its rows of the
batch and its shard of the cache (``init_cache_shard``), against the
reference's unsharded ``forward`` on the same weights: a prefill and 3
greedy decode steps, logits within 1e-4 and the greedy tokens equal.
Under ``long_context_rules`` + ``flash_decode`` (batch 1, a ring that
the prompt wraps, its slots split over ``data``) also against the
reference's ``forward`` under the same rules on the Auto 1x1 mesh. The
collectives of a decode step are counted against the design's count.
Every family of the reference runs under the rules (the ssm, hybrid and
audio families' parity with the reference is in
``test_torch_ssm_parallel.py`` and ``test_torch_audio_parallel.py``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.parallel import sharding as JSH
from repro_torch.bridge import shard_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from _torch_mesh import auto_mesh, rows, run_mesh
from _torch_parity import one_torch_thread  # noqa: F401

STEPS = 3
TOL = 1e-4
# name -> (arch, config changes, mesh, long context, B, prompt, M, impl,
#          collectives of one decode step)
CASES = {
    "tinyllama-1x2": ("tinyllama-1.1b", (), (1, 2), False, 2, 10, 32,
                      "gather", {"all-reduce": 5, "all-gather": 1}),
    "tinyllama-2x2-kernel": ("tinyllama-1.1b", (), (2, 2), False, 4, 10, 32,
                             "kernel", {"all-reduce": 5, "all-gather": 1}),
    # heads split 4 ways, KV heads (2) whole: the cache's sequence splits
    # over `model` and each rank's query heads read one global KV head
    "gqa-h8kv2-1x4": ("tinyllama-1.1b", (("num_heads", 8),
                                         ("num_kv_heads", 2)), (1, 4), False,
                      2, 10, 32, "gather",
                      {"all-reduce": 11, "all-gather": 3}),
    "minicpm3-1x2": ("minicpm3-4b", (), (1, 2), False, 2, 10, 32, "gather",
                     {"all-reduce": 5, "all-gather": 1}),
    "qwen2-moe-2x2": ("qwen2-moe-a2.7b", (), (2, 2), False, 4, 10, 32,
                      "gather", {"all-reduce": 9, "all-gather": 3}),
    "tinyllama-long-2x1": ("tinyllama-1.1b", (), (2, 1), True, 1, 72, 64,
                           "kernel", {"all-reduce": 6}),
    "tinyllama-long-4x1": ("tinyllama-1.1b", (), (4, 1), True, 1, 72, 64,
                           "gather", {"all-reduce": 6}),
    "minicpm3-long-2x1": ("minicpm3-4b", (), (2, 1), True, 1, 72, 64,
                          "gather", {"all-reduce": 6}),
    "qwen2-moe-long-2x1": ("qwen2-moe-a2.7b", (), (2, 1), True, 1, 72, 64,
                           "gather", {"all-reduce": 8}),
    # a logit softcap on the flash-decoding path, heads split over model
    "gemma-softcap-long-2x2": ("gemma-7b", (("logit_softcap", 30.0),),
                               (2, 2), True, 1, 72, 64, "gather",
                               {"all-reduce": 11, "all-gather": 1}),
}


@functools.cache
def _pair(arch, changes):
    """(jax cfg, jax params, port cfg, numpy params): ``arch.reduced()``
    with ``changes``, fp32 weights drawn by the port's ``init_params``
    from a seed (the two trees match key for key), as numpy for the port's
    shards and as arrays for the reference."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **dict(changes))
    tcfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "float32")
    np_params = jax.tree_util.tree_map(lambda t: t.numpy(), tp)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, np_params), tcfg, \
        np_params


def _tokens(cfg, B, S):
    return np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)


@functools.cache
def _ref_stream(arch, changes, B, S, M, long_ctx, under_rules=False):
    """The reference's prefill and STEPS greedy decode steps (a scan)
    under one jit, shared by the cases of one input: the logits of each
    call [STEPS + 1, B, V] and the greedy tokens [B, STEPS + 1]. With
    ``under_rules``, under ``long_context_rules`` + ``flash_decode`` on
    the Auto 1x1 mesh."""
    jcfg, jp, tcfg, _ = _pair(arch, changes)
    toks = _tokens(tcfg, B, S)
    window = jcfg.sliding_window if long_ctx else None

    def run(p):
        cache = JT.init_cache(jcfg, B, M, "float32")
        lg, cache, _ = JT.forward(p, jcfg, toks, cache=cache, mode="prefill",
                                  window=window, dispatch="dense")
        first = jnp.argmax(lg[:, :jcfg.vocab_size], -1)

        def step(carry, t):
            cache, tok = carry
            pos = jnp.full((B, 1), S + t, jnp.int32)
            lg, cache, _ = JT.forward(p, jcfg, tok[:, None].astype(jnp.int32),
                                      positions=pos, cache=cache,
                                      mode="decode", window=window,
                                      dispatch="dense")
            nxt = jnp.argmax(lg[:, :jcfg.vocab_size], -1)
            return (cache, nxt), (lg, nxt)

        _, (lgs, nxt) = jax.lax.scan(step, (cache, first), jnp.arange(STEPS))
        return (jnp.concatenate([lg[None], lgs]),
                jnp.concatenate([first[:, None], nxt.T], 1))

    if not under_rules:
        return jax.tree_util.tree_map(np.asarray, jax.jit(run)(jp))
    mesh = auto_mesh()
    rules = dict(JSH.long_context_rules(jcfg, mesh), flash_decode=True,
                 mesh=mesh)
    with JSH.use_rules(rules), jax.set_mesh(mesh):
        return jax.tree_util.tree_map(np.asarray, jax.jit(run)(jp))


def _port_stream(tcfg, np_params, toks, M, window, rules, mesh, impl):
    """This rank's prefill and greedy decode steps under ``rules``: its
    logits [STEPS + 1, b, V], tokens [b, STEPS + 1] and the collectives
    of each decode step."""
    specs = SH.param_specs(tcfg, np_params, rules, mesh)
    p = shard_from_numpy(np_params, specs, mesh, "cpu")
    B = toks.shape[0]
    mine = torch.from_numpy(toks[rows(mesh, rules, B)])
    b, S = mine.shape
    cache = T.init_cache_shard(tcfg, B, M, rules, mesh, "float32", "cpu")
    outs, colls = [], []
    with SH.use_rules(rules):
        lg, _, _ = T.forward(p, tcfg, mine, cache=cache, mode="prefill",
                             window=window, attn_impl=impl)
        outs.append(lg)
        nxt = [lg[:, :tcfg.vocab_size].argmax(-1)]
        for t in range(STEPS):
            before = dict(mesh.collectives)
            pos = torch.full((b, 1), S + t, dtype=torch.int32)
            lg, _, _ = T.forward(p, tcfg, nxt[-1][:, None], positions=pos,
                                 cache=cache, mode="decode", window=window,
                                 attn_impl=impl)
            colls.append({k: v - before.get(k, 0)
                          for k, v in mesh.collectives.items()
                          if v - before.get(k, 0)})
            outs.append(lg)
            nxt.append(lg[:, :tcfg.vocab_size].argmax(-1))
    return (torch.stack(outs).numpy(), torch.stack(nxt, 1).numpy(), colls)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_reference(case):
    arch, changes, shape, long_ctx, B, S, M, impl, per_step = CASES[case]
    _, _, tcfg, np_params = _pair(arch, changes)
    toks = _tokens(tcfg, B, S)
    window = tcfg.sliding_window if long_ctx else None
    want, want_tok = _ref_stream(arch, changes, B, S, M, long_ctx)
    if long_ctx:   # the reference's own sharded path, on the Auto mesh
        ref_sh, ref_sh_tok = _ref_stream(arch, changes, B, S, M, True, True)
        np.testing.assert_allclose(ref_sh, want, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(ref_sh_tok, want_tok)

    def rank(mesh):
        if long_ctx:
            rules = SH.long_context_rules(tcfg, mesh)
            rules["flash_decode"] = True
        else:
            rules = SH.rules_for(tcfg, mesh)
        rules["mesh"] = mesh
        sl = rows(mesh, rules, B)
        return sl, _port_stream(tcfg, np_params, toks, M, window, rules,
                                mesh, impl)

    V = tcfg.vocab_size
    for sl, (got, tok, colls) in run_mesh(shape, rank):
        np.testing.assert_allclose(got[..., :V], want[:, sl, :V], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tok, want_tok[sl])
        assert colls == [per_step] * STEPS


def test_rules_split_what_they_name():
    """At (1,4) with 8 heads of which 2 KV: the query heads split, the
    KV heads stay whole and the cache's sequence splits over model; the
    rank-local cache is allocated at its shard's shape."""
    _, _, tcfg, np_params = _pair("tinyllama-1.1b",
                                  (("num_heads", 8), ("num_kv_heads", 2)))

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        cache = T.init_cache_shard(tcfg, 2, 32, rules, mesh, "float32", "cpu")
        p = shard_from_numpy(np_params, SH.param_specs(tcfg, np_params, rules,
                                                       mesh), mesh, "cpu")
        return (rules["heads"], rules["kv_heads"], rules["cache_seq"],
                tuple(cache["layers"]["k"].shape),
                tuple(cache["positions"].shape),
                int(cache["positions"].min()),
                tuple(p["layers"]["attn"]["wq"].shape),
                tuple(p["layers"]["attn"]["wk"].shape))

    hd = tcfg.resolved_head_dim
    assert run_mesh((1, 4), rank) == [
        ("model", None, "model", (2, 2, 8, 2, hd), (2, 8), T.BIG_POS,
         (2, tcfg.d_model, 2, hd), (2, tcfg.d_model, 2, hd))] * 4


#: one arch of each family (a hybrid with 3 layers, so its tail runs)
FAMILY_ARCHS = {"dense": ("tinyllama-1.1b", ()),
                "moe": ("qwen2-moe-a2.7b", ()),
                "vlm": ("chameleon-34b", ()),
                "ssm": ("mamba2-780m", ()),
                "hybrid": ("zamba2-7b", (("num_layers", 3),)),
                "audio": ("whisper-medium", ())}


@pytest.mark.parametrize("family", T.FAMILIES)
def test_every_family_runs_under_rules(family):
    """Every family of the reference runs under sharding rules: on
    (1, 2) under ``rules_for`` each rank's train-mode logits equal the
    unsharded forward's on the same weights (1e-5), whisper's over its
    frames."""
    arch, changes = FAMILY_ARCHS[family]
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    assert cfg.family == family
    full = T.init_params(cfg, torch.Generator().manual_seed(0), "float32")
    np_params = jax.tree_util.tree_map(lambda t: t.numpy(), full)
    toks = torch.from_numpy(_tokens(cfg, 2, 8)).long()
    frames = (torch.randn((2, cfg.encoder_seq_len, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
              if family == "audio" else None)
    want = T.forward(full, cfg, toks, encoder_input=frames)[0]

    def rank(mesh):
        rules = dict(SH.rules_for(cfg, mesh), mesh=mesh)
        p = shard_from_numpy(np_params, SH.param_specs(cfg, np_params, rules,
                                                       mesh), mesh, "cpu")
        with SH.use_rules(rules):
            T.check_supported(cfg)
            return T.forward(p, cfg, toks, encoder_input=frames)[0]

    V = cfg.vocab_size
    for got in run_mesh((1, 2), rank):
        torch.testing.assert_close(got[..., :V], want[..., :V], rtol=1e-5,
                                   atol=1e-5)
