"""Port parity, MLA attention (minicpm3-4b): repro_torch's MLA layer and
decoder against repro.models with the same weights (the reference's
init_params bridged through numpy), and the port's dense-cache engine
against the reference's ``Engine(cache_kind="dense")``.

Variants: "wq" is ``.reduced()`` (``q_lora_rank`` 0: one query matrix
``wq``), "wq_ab" the same with ``q_lora_rank=32`` (``wq_a`` then
``wq_b``, the full-width form). Tolerances: fp32 1e-4 elementwise; bf16
2e-2 relative L2 per tensor."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as torch_configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import Engine
from repro_torch.serving.instrument import count_host_syncs
from _torch_parity import jit, one_torch_thread, specs  # noqa: F401

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KEY = jax.random.PRNGKey(0)
VARIANTS = ("wq", "wq_ab")


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """JAX 0.9's default random bits (the port's sampler reproduces them);
    older JAX releases need it set."""
    with jax.threefry_partitionable(True):
        yield


def _cfgs(variant):
    out = []
    for mod in (jax_configs, torch_configs):
        cfg = mod.get_config("minicpm3-4b").reduced()
        if variant == "wq_ab":
            cfg = dataclasses.replace(cfg, q_lora_rank=32)
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def _params(variant, dtype):
    """The reference's weights and their bridge. bf16 ones are the fp32
    draw narrowed, which is what the reference's bf16 init_params gives
    (it draws in fp32), at the cost of one init compile instead of two."""
    jcfg, tcfg = _cfgs(variant)
    if dtype == "float32":
        jp = jit(JT.init_params, jcfg, KEY, dtype)
    else:
        want = jax.eval_shape(lambda: JT.init_params(jcfg, KEY, dtype))
        jp = jax.tree_util.tree_map(lambda a, s: a.astype(s.dtype),
                                    _params(variant, "float32")[1], want)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _leaves(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _specs(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _leaves(tree).items()}


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if tol == TOL["bfloat16"]:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= tol, f"relative L2 error {err:.3e} > {tol}"
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _close_trees(tc, jc, tol):
    jl, tl = _leaves(jc), _leaves(tc)
    assert jl.keys() == tl.keys()
    for k, v in jl.items():
        _close(tl[k], v, tol)


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_and_cache_match_reference_trees(variant):
    """The port's own init_params (``wq`` or ``wq_a``/``wq_b``) and
    init_cache (latents ``c`` and ``kr``) give the reference's keys,
    shapes and dtypes."""
    jcfg, tcfg = _cfgs(variant)
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, KEY, "bfloat16"))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "bfloat16")
    assert _specs(tp) == _specs(jp)
    assert ("wq_a" in tp["layers"]["attn"]) == (variant == "wq_ab")
    for B, M in ((3, 16), (1, 8)):
        jc = jax.eval_shape(lambda: JT.init_cache(jcfg, B, M, "bfloat16"))
        tc = TT.init_cache(tcfg, B, M, "bfloat16", "cpu")
        assert _specs(tc) == _specs(jc)


@pytest.mark.parametrize("variant", VARIANTS)
def test_mla_layer_forms_match_reference(variant):
    """One layer alone: the expanded form (prefill, latents written at
    ``slots``) and then the absorbed form (decode of one token, written
    before attending), against ``repro.models.layers`` in fp32."""
    jcfg, jp, tcfg, tp = _params(variant, "float32")
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    lp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(0)
    B, S, M = 2, 7, 12
    x = rng.standard_normal((B, S + 1, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S + 1, dtype=np.int32), (B, S + 1)).copy()
    r, ro = jcfg.kv_lora_rank, jcfg.qk_rope_head_dim
    jc = {"c": jnp.zeros((B, M, r)), "kr": jnp.zeros((B, M, ro))}
    tc = {"c": torch.zeros((B, M, r)), "kr": torch.zeros((B, M, ro))}
    want, jc = jit(JL.apply_mla_prefill, jl, jnp.asarray(x[:, :S]), jcfg,
                   positions=jnp.asarray(pos[:, :S]), cache=jc,
                   slots=jnp.asarray(pos[:, :S]))
    got, tc = TL.apply_mla_prefill(lp, torch.from_numpy(x[:, :S]), tcfg,
                                   positions=torch.from_numpy(pos[:, :S]),
                                   cache=tc,
                                   slots=torch.from_numpy(pos[:, :S]).long())
    _close(got, want, TOL["float32"])
    _close_trees(tc, jc, TOL["float32"])
    kpos = np.where(np.arange(M) <= S, np.arange(M), 2 ** 30).astype(np.int32)
    kpos = np.broadcast_to(kpos, (B, M)).copy()
    want, jc = jit(JL.apply_mla_decode, jl, jnp.asarray(x[:, S:]), jcfg,
                   positions=jnp.asarray(pos[:, S:]), cache=jc,
                   slots=jnp.asarray(pos[:, S:]), k_positions=jnp.asarray(kpos))
    got, tc = TL.apply_mla_decode(lp, torch.from_numpy(x[:, S:]), tcfg,
                                  positions=torch.from_numpy(pos[:, S:]),
                                  cache=tc,
                                  slots=torch.from_numpy(pos[:, S:]).long(),
                                  k_positions=torch.from_numpy(kpos))
    _close(got, want, TOL["float32"])
    _close_trees(tc, jc, TOL["float32"])


def _steps(S):
    """(start, length, mode) of a prefill, one decode step and a 3-token
    extension."""
    return ((0, S, "prefill"), (S, 1, "decode"), (S + 1, 3, "decode"))


def _pos(B, s0, n):
    return np.broadcast_to(np.arange(s0, s0 + n, dtype=np.int32),
                           (B, n)).copy()


def _reference_steps(jp, jcfg, toks, S, M, dtype, window, train):
    """The reference's (logits, cache) after each of ``_steps(S)`` over a
    fresh cache, and its train-mode logits over all of ``toks``: one jit,
    so one compile."""
    B = toks.shape[0]

    def run():
        jc, out = JT.init_cache(jcfg, B, M, dtype), []
        for s0, n, mode in _steps(S):
            pos = None if mode == "prefill" else jnp.asarray(_pos(B, s0, n))
            jl, jc, _ = JT.forward(jp, jcfg, jnp.asarray(toks[:, s0:s0 + n]),
                                   pos, jc, mode=mode, window=window)
            out.append((jl, jc))
        jl = (JT.forward(jp, jcfg, jnp.asarray(toks), mode="train")[0]
              if train else None)
        return out, jl

    return jax.jit(run)()


@pytest.mark.parametrize("variant,dtype,ring", [
    ("wq", "float32", False), ("wq_ab", "float32", False),
    ("wq", "float32", True), ("wq_ab", "bfloat16", False)])
def test_forward_prefill_decode_extend(variant, dtype, ring):
    """Prefill over a fresh dense cache (the expanded form), one decode
    step and a 3-token extension (the absorbed form): logits and every
    cache leaf agree; then train-mode logits. ``ring``: the window of 64
    over a 64-row cache, the prefill 70 tokens long, so only its last 64
    latents land and the decode steps wrap."""
    jcfg, jp, tcfg, tp = _params(variant, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(1)
    B, S, M = (2, 70, 64) if ring else (2, 10, 16)
    window = jcfg.sliding_window if ring else None
    toks = rng.integers(2, jcfg.vocab_size, size=(B, S + 4)).astype(np.int32)
    steps, jtrain = _reference_steps(jp, jcfg, toks, S, M, dtype, window,
                                     not ring)
    tc = TT.init_cache(tcfg, B, M, dtype, "cpu")
    for (s0, n, mode), (jl, jc) in zip(_steps(S), steps):
        pos = None if mode == "prefill" else torch.from_numpy(_pos(B, s0, n))
        tl, tc, _ = TT.forward(tp, tcfg, torch.from_numpy(toks[:, s0:s0 + n]),
                               pos, tc, mode=mode, window=window)
        _close(tl, jl, tol)
        _close_trees(tc, jc, tol)
    if not ring:
        tl = TT.forward(tp, tcfg, torch.from_numpy(toks), mode="train")[0]
        _close(tl, jtrain, tol)


def test_absorbed_decode_equals_expanded_prefill():
    """The two forms compute one function: the logits of a decode step
    after a prefill equal those of one prefill over the prompt plus that
    token (fp32, the port alone)."""
    _, _, tcfg, tp = _params("wq_ab", "float32")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(
        rng.integers(2, tcfg.vocab_size, size=(2, 9)).astype(np.int32))
    tc = TT.init_cache(tcfg, 2, 16, "float32", "cpu")
    TT.forward(tp, tcfg, toks[:, :8], cache=tc, mode="prefill")
    dec, _, _ = TT.forward(tp, tcfg, toks[:, 8:], torch.full((2, 1), 8), tc,
                           mode="decode")
    ref, _, _ = TT.forward(tp, tcfg, toks, mode="prefill",
                           cache=TT.init_cache(tcfg, 2, 16, "float32", "cpu"))
    torch.testing.assert_close(dec, ref, rtol=1e-4, atol=1e-4)


def test_attention_routes_agree_on_cpu():
    """MLA has no kernel (the reference attends it with jnp in both
    forms): ``attn_impl="kernel"`` computes exactly what "gather" does."""
    _, _, tcfg, tp = _params("wq", "float32")
    toks = torch.arange(2, 12, dtype=torch.int32).reshape(1, 10)
    out = []
    for impl in ("kernel", "gather"):
        tc = TT.init_cache(tcfg, 1, 16, "float32", "cpu")
        TT.forward(tp, tcfg, toks[:, :9], cache=tc, mode="prefill",
                   attn_impl=impl)
        out.append(TT.forward(tp, tcfg, toks[:, 9:], torch.full((1, 1), 9),
                              tc, mode="decode", attn_impl=impl)[0])
    assert torch.equal(out[0], out[1])


# ------------------------------------------------------------- the engine
def _rows(lens, seed, vocab, n=6, sampled=(1,)):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(2, vocab, size=s).astype(np.int32), n,
             0.8 if i in sampled else 0.0, 8 if i in sampled else 0, 7 + i)
            for i, s in enumerate(lens)]


def _streams(eng, rows, jax_side):
    for spec in specs(rows, jax_side=jax_side):
        eng.submit(spec)
    return {r.rid: list(r.generated) for r in eng.run_until_done()}


#: (variant, engine keywords, prompt lengths): two slots, so admissions
#: interleave with decode and slots are reused
CASES = {
    "one-shot": ("wq", dict(max_len=32), [9, 12, 12, 9]),
    "chunked": ("wq_ab", dict(max_len=32, prefill_chunk=4), [9, 12, 12, 9]),
    "ring": ("wq", dict(max_len=96, swa=True, prefill_chunk=32), [70, 66]),
}


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The case's rows and the reference engine's streams (one run,
    shared by the tests that compare against it)."""
    variant, kw, lens = CASES[case]
    jcfg, jp, tcfg, _ = _params(variant, "float32")
    rows = _rows(lens, seed=3, vocab=tcfg.vocab_size,
                 n=8 if case == "ring" else 6)
    rows.append((9, rows[1][1][:9], 1, 0.0, 0, 0))   # done at admission
    want = _streams(JaxEngine(jcfg, jp, cache_kind="dense", max_batch=2,
                              **kw), rows, True)
    return rows, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_match_reference(case):
    """Greedy and sampled requests, one-shot (``wq``), with
    ``prefill_chunk=4`` (``wq_a``/``wq_b``) and on the sliding-window ring
    (window 64, ``max_len`` 96: prompts longer than the window, chunked
    by 32, decoding past the wrap); a max_tokens=1 request finishes at
    admission and never takes a decode slot."""
    variant, kw, _ = CASES[case]
    _, _, tcfg, tp = _params(variant, "float32")
    rows, want = _reference(case)
    eng = Engine(tcfg, tp, cache_kind="dense", device="cpu", max_batch=2,
                 **kw)
    got = _streams(eng, rows, False)
    assert got == want
    assert len(got[9]) == 1 and not eng.active
    if case == "ring":
        assert eng.max_len == 64 and eng.cache["layers"]["c"].shape[2] == 64


def test_one_host_sync_per_steady_step():
    _, _, tcfg, tp = _params("wq_ab", "float32")
    eng = Engine(tcfg, tp, cache_kind="dense", device="cpu", max_batch=2,
                 max_len=64)
    for spec in specs(_rows([9, 12], seed=6, vocab=tcfg.vocab_size, n=12),
                      jax_side=False):
        eng.submit(spec)
    eng.step()          # admits both, then decodes
    for _ in range(5):
        n = eng._step_count
        with count_host_syncs() as c:
            eng.step()
        assert eng._step_count == n + 1 and c.n == 1
