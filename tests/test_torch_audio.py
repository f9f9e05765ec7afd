"""Port parity, the audio encoder-decoder (whisper-medium ``.reduced()``):
repro_torch's encoder, cross-attention and decoder against repro.models
with the same weights (the reference's init_params bridged through
numpy), and the port's dense-cache engine against the reference's
``Engine(cache_kind="dense")``, with and without an
``encoder_input_fn``.

Frames are fp32, as the reference engine's default zero frames are: with
bf16 weights the reference promotes every mixed einsum to fp32, so its
encoder and the prefill's cross K/V run in fp32. Tolerances: fp32 1e-4
elementwise; bf16 2e-2 relative L2 per tensor."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as torch_configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import Engine
from repro_torch.serving.instrument import count_host_syncs
from _torch_parity import jit, one_torch_thread, specs  # noqa: F401

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """JAX 0.9's default random bits (the port's sampler reproduces them);
    older JAX releases need it set."""
    with jax.threefry_partitionable(True):
        yield


def _cfgs():
    return [mod.get_config("whisper-medium").reduced()
            for mod in (jax_configs, torch_configs)]


@functools.lru_cache(maxsize=None)
def _params(dtype):
    """The reference's weights and their bridge. bf16 ones are the fp32
    draw narrowed, which is what the reference's bf16 init_params gives
    (it draws in fp32), at the cost of one init compile instead of two."""
    jcfg, tcfg = _cfgs()
    if dtype == "float32":
        jp = jit(JT.init_params, jcfg, KEY, dtype)
    else:
        want = jax.eval_shape(lambda: JT.init_params(jcfg, KEY, dtype))
        jp = jax.tree_util.tree_map(lambda a, s: a.astype(s.dtype),
                                    _params("float32")[1], want)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


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
        assert str(tl[k].dtype).replace("torch.", "") == str(v.dtype), k
        _close(tl[k], v, tol)


def test_init_params_and_cache_match_reference_trees():
    """Decoder layers with ``norm_x`` / ``xattn``, the ``encoder``'s
    layers and final norm; the cache's ``cross`` K/V of
    ``encoder_seq_len`` rows: the reference's keys, shapes and dtypes."""
    jcfg, tcfg = _cfgs()
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, KEY, "bfloat16"))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "bfloat16")
    assert _specs(tp) == _specs(jp)
    for B, M in ((3, 16), (1, 8)):
        jc = jax.eval_shape(lambda: JT.init_cache(jcfg, B, M, "bfloat16"))
        tc = TT.init_cache(tcfg, B, M, "bfloat16", "cpu")
        assert _specs(tc) == _specs(jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_audio_matches_reference(dtype):
    """The encoder over fp32 frames; with bf16 weights both run in fp32
    (the promotion) and return fp32."""
    jcfg, jp, tcfg, tp = _params(dtype)
    frames = _frames(jcfg, 2, 0)
    want = jit(JT.encode_audio, jp, jcfg, jnp.asarray(frames))
    got = TT.encode_audio(tp, tcfg, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, TOL[dtype])


def _steps(S):
    """(start, length, mode) of a prefill, one decode step and a 3-token
    extension."""
    return ((0, S, "prefill"), (S, 1, "decode"), (S + 1, 3, "decode"))


def _pos(B, s0, n):
    return np.broadcast_to(np.arange(s0, s0 + n, dtype=np.int32),
                           (B, n)).copy()


def _reference_steps(jp, jcfg, toks, frames, S, M, dtype):
    """The reference's (logits, cache) after each of ``_steps(S)`` over a
    fresh cache (the prefill encodes ``frames``), and its train-mode
    logits over all of ``toks``: one jit, so one compile."""
    B = toks.shape[0]

    def run():
        jc, out = JT.init_cache(jcfg, B, M, dtype), []
        for s0, n, mode in _steps(S):
            pre = mode == "prefill"
            jl, jc, _ = JT.forward(
                jp, jcfg, jnp.asarray(toks[:, s0:s0 + n]),
                None if pre else jnp.asarray(_pos(B, s0, n)), jc, mode=mode,
                encoder_input=jnp.asarray(frames) if pre else None)
            out.append((jl, jc))
        jl = JT.forward(jp, jcfg, jnp.asarray(toks), mode="train",
                        encoder_input=jnp.asarray(frames))[0]
        return out, jl

    return jax.jit(run)()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_extend(dtype):
    """Prefill over a fresh dense cache (encodes the frames, caches the
    cross K/V: fp32 in both packages, also with bf16 weights), one decode
    step and a 3-token extension reading them from the cache: logits and
    every cache leaf, dtypes included, agree; then train-mode logits."""
    jcfg, jp, tcfg, tp = _params(dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(1)
    B, S, M = 2, 10, 16
    frames = _frames(jcfg, B, 1)
    toks = rng.integers(2, jcfg.vocab_size, size=(B, S + 4)).astype(np.int32)
    steps, jtrain = _reference_steps(jp, jcfg, toks, frames, S, M, dtype)
    tc = TT.init_cache(tcfg, B, M, dtype, "cpu")
    for (s0, n, mode), (jl, jc) in zip(_steps(S), steps):
        pre = mode == "prefill"
        tl, tc, _ = TT.forward(
            tp, tcfg, torch.from_numpy(toks[:, s0:s0 + n]),
            None if pre else torch.from_numpy(_pos(B, s0, n)), tc, mode=mode,
            encoder_input=torch.from_numpy(frames) if pre else None)
        _close(tl, jl, tol)
        _close_trees(tc, jc, tol)
        if pre:
            assert tc["cross"]["k"].dtype == torch.float32
    tl = TT.forward(tp, tcfg, torch.from_numpy(toks), mode="train",
                    encoder_input=torch.from_numpy(frames))[0]
    _close(tl, jtrain, tol)


def test_prefill_needs_frames():
    _, _, tcfg, tp = _params("float32")
    tc = TT.init_cache(tcfg, 1, 8, "float32", "cpu")
    with pytest.raises(ValueError, match="encoder frames"):
        TT.forward(tp, tcfg, torch.ones((1, 4), dtype=torch.int32), cache=tc,
                   mode="prefill")


def test_kernel_routes_agree_with_plain_on_cpu(monkeypatch):
    """``attn_impl="kernel"``: a decode step's self-attention and its
    cross-attention over the cached encoder K/V go through
    ``decode_attention`` (on CPU tensors its plain version stands in),
    two calls a layer, the cross call on transposed views of the cache
    with lengths ``encoder_seq_len``; the logits and caches equal the
    gather route's."""
    from repro_torch.models import layers as TL

    _, _, tcfg, tp = _params("float32")
    calls = []
    real = TL.decode_attention

    def counted(q, k, v, lengths):
        calls.append((k.shape[2], k.is_contiguous(), lengths.tolist()))
        return real(q, k, v, lengths)

    monkeypatch.setattr(TL, "decode_attention", counted)
    rng = np.random.default_rng(2)
    B, S, M = 2, 9, 16
    frames = torch.from_numpy(_frames(tcfg, B, 2))
    toks = torch.from_numpy(
        rng.integers(2, tcfg.vocab_size, size=(B, S + 1)).astype(np.int32))
    out = {}
    for impl in ("kernel", "gather"):
        tc = TT.init_cache(tcfg, B, M, "float32", "cpu")
        pl, tc, _ = TT.forward(tp, tcfg, toks[:, :S], cache=tc,
                               mode="prefill", encoder_input=frames,
                               attn_impl=impl)
        dl, tc, _ = TT.forward(tp, tcfg, toks[:, S:],
                               torch.full((B, 1), S, dtype=torch.int32), tc,
                               mode="decode", attn_impl=impl)
        out[impl] = (pl, dl, tc)
    E = tcfg.encoder_seq_len
    assert calls == [(M, False, [S + 1] * B), (E, False, [E] * B)] \
        * tcfg.num_layers
    for a, b in zip(out["kernel"][:2], out["gather"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for k, v in _leaves(out["gather"][2]).items():
        torch.testing.assert_close(_leaves(out["kernel"][2])[k], v,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_one_token_calls_take_the_kernel_route(mode, monkeypatch):
    """A 1-token prefill or train call attends the encoder's fresh cross
    K/V: under ``attn_impl="kernel"`` through ``decode_attention`` with
    lengths ``encoder_seq_len`` (made by the stack, as a decode step's
    are), and its logits equal the gather route's."""
    from repro_torch.models import layers as TL

    _, _, tcfg, tp = _params("float32")
    lengths = []
    real = TL.decode_attention

    def counted(q, k, v, kv_len):
        lengths.append(kv_len.tolist())
        return real(q, k, v, kv_len)

    monkeypatch.setattr(TL, "decode_attention", counted)
    B, E = 2, tcfg.encoder_seq_len
    frames = torch.from_numpy(_frames(tcfg, B, 4))
    toks = torch.full((B, 1), 5, dtype=torch.int32)
    out = {}
    for impl in ("kernel", "gather"):
        tc = (TT.init_cache(tcfg, B, 8, "float32", "cpu")
              if mode == "prefill" else None)
        out[impl] = TT.forward(tp, tcfg, toks, cache=tc, mode=mode,
                               encoder_input=frames, attn_impl=impl)[0]
    assert lengths == [[E] * B] * tcfg.num_layers
    torch.testing.assert_close(out["kernel"], out["gather"], rtol=1e-4,
                               atol=1e-4)


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


def _frames_fn(cfg, jax_side):
    """Each request's frames from a seed of its rid."""
    def fn(req):
        f = _frames(cfg, 1, 100 + req.rid)
        return jnp.asarray(f) if jax_side else f
    return fn


#: (prefill_chunk, frames from encoder_input_fn): two slots, so
#: admissions interleave with decode and slots are reused
CASES = {"zeros": (0, False), "frames": (0, True),
         "chunked-frames": (4, True)}


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The case's rows and the reference engine's streams (one run,
    shared by the tests that compare against it)."""
    chunk, frames = CASES[case]
    jcfg, jp, tcfg, _ = _params("float32")
    rows = _rows([9, 12, 12, 1], seed=3, vocab=tcfg.vocab_size)
    rows.append((9, rows[1][1][:9], 1, 0.0, 0, 0))   # done at admission
    fn = _frames_fn(jcfg, True) if frames else None
    want = _streams(JaxEngine(jcfg, jp, cache_kind="dense", max_batch=2,
                              max_len=32, prefill_chunk=chunk,
                              encoder_input_fn=fn), rows, True)
    return rows, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_match_reference(case):
    """Greedy and sampled requests over the default zero frames and over
    each request's own frames, one-shot and with ``prefill_chunk=4``,
    under the default kernel route; a 1-token prompt (whisper's
    start-of-transcript form) prefills at S == 1, where cross-attention
    takes the kernel route too; a max_tokens=1 request finishes at
    admission."""
    chunk, frames = CASES[case]
    _, _, tcfg, tp = _params("float32")
    rows, want = _reference(case)
    fn = _frames_fn(tcfg, False) if frames else None
    eng = Engine(tcfg, tp, cache_kind="dense", device="cpu", max_batch=2,
                 max_len=32, prefill_chunk=chunk, encoder_input_fn=fn)
    got = _streams(eng, rows, False)
    assert got == want
    assert len(got[9]) == 1 and not eng.active
    assert eng.cache["cross"]["k"].dtype == torch.float32


def test_frames_change_the_streams():
    """The frames reach the decoder: the zero frames and each request's
    own give other streams."""
    zeros, frames = _reference("zeros")[1], _reference("frames")[1]
    assert zeros != frames


def test_attention_routes_give_the_same_streams():
    _, _, tcfg, tp = _params("float32")
    rows = _rows([9, 12], seed=5, vocab=tcfg.vocab_size)
    out = []
    for impl in ("kernel", "gather"):
        eng = Engine(tcfg, tp, cache_kind="dense", device="cpu", max_batch=2,
                     max_len=32, dense_attn_impl=impl,
                     encoder_input_fn=_frames_fn(tcfg, False))
        out.append(_streams(eng, rows, False))
    assert out[0] == out[1]


def test_one_host_sync_per_steady_step():
    _, _, tcfg, tp = _params("float32")
    eng = Engine(tcfg, tp, cache_kind="dense", device="cpu", max_batch=2,
                 max_len=64, encoder_input_fn=_frames_fn(tcfg, False))
    for spec in specs(_rows([9, 12], seed=6, vocab=tcfg.vocab_size, n=12),
                      jax_side=False):
        eng.submit(spec)
    eng.step()          # admits both, then decodes
    for _ in range(5):
        n = eng._step_count
        with count_host_syncs() as c:
            eng.step()
        assert eng._step_count == n + 1 and c.n == 1
