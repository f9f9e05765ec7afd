"""Port parity, the dense-cache engine end to end on the CPU: the port's
Engine(cache_kind="dense", device="cpu") yields the reference
Engine(cache_kind="dense")'s token streams for a GQA decoder
(tinyllama-1.1b), an SSM (mamba2-780m) and a hybrid (zamba2-7b), all
``.reduced()`` in fp32 with the reference's weights: greedy and sampled
requests, chunked prefill, the sliding-window ring and a request that
finishes at admission; the attention routes against each other; the
prefill's scan through the SSD op; one host sync per steady step; and
the dense engine's refusals."""
import functools

import jax
import numpy as np
import pytest

from repro.serving.engine import Engine as JaxEngine
from repro_torch.kernels import ops as OPS
from repro_torch.serving.engine import Engine
from repro_torch.serving.instrument import count_host_syncs
from _torch_parity import one_torch_thread, specs, tiny_pair  # noqa: F401

ARCHS = ("tinyllama-1.1b", "mamba2-780m", "zamba2-7b")


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """JAX 0.9's default random bits (the port's sampler reproduces them);
    older JAX releases need it set."""
    with jax.threefry_partitionable(True):
        yield


@functools.lru_cache(maxsize=None)
def _pair(arch):
    return tiny_pair(arch)


def _rows(lens, seed, vocab, n=6, sampled=(1,)):
    """(rid, prompt, max_tokens, temperature, top_k, seed) rows; the
    rows in ``sampled`` draw at temperature 0.8 from the top 8."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(2, vocab, size=s).astype(np.int32), n,
             0.8 if i in sampled else 0.0, 8 if i in sampled else 0, 7 + i)
            for i, s in enumerate(lens)]


def _streams(eng, rows, jax_side):
    for spec in specs(rows, jax_side=jax_side):
        eng.submit(spec)
    return {r.rid: list(r.generated) for r in eng.run_until_done()}


def _both(arch, rows, **kw):
    jcfg, jp, tcfg, tp = _pair(arch)
    want = _streams(JaxEngine(jcfg, jp, cache_kind="dense", **kw), rows,
                    True)
    eng = Engine(tcfg, tp, cache_kind="dense", device="cpu", **kw)
    return eng, _streams(eng, rows, False), want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [0, 4])
def test_streams_match_reference(arch, chunk):
    """Four requests through two slots (so admissions interleave with
    decode and slots are reused), greedy and sampled, one-shot and with
    ``prefill_chunk=4``; a max_tokens=1 request finishes at admission
    and never takes a decode slot. Two prompt lengths keep the
    reference's prefill compilations to two."""
    vocab = _pair(arch)[2].vocab_size
    rows = _rows([9, 12, 12, 9], seed=3, vocab=vocab)
    rows.append((9, rows[1][1][:9], 1, 0.0, 0, 0))
    eng, got, want = _both(arch, rows, max_batch=2, max_len=32,
                           prefill_chunk=chunk)
    assert got == want
    assert len(got[9]) == 1 and all(len(got[i]) == 6 for i in range(4))
    assert eng.sched.name == "phase" and not eng.active


def test_ring_matches_reference():
    """The sliding-window ring: tinyllama's reduced window of 64 with
    max_len 96, so the cache holds 64 rows; prompts longer than the
    window, one-shot and chunked, decoding past the wrap."""
    vocab = _pair("tinyllama-1.1b")[2].vocab_size
    rows = _rows([70, 66], seed=4, vocab=vocab, n=8)
    for chunk in (0, 32):
        eng, got, want = _both("tinyllama-1.1b", rows, max_batch=2,
                               max_len=96, swa=True, prefill_chunk=chunk)
        assert got == want
        assert eng.max_len == 64 and eng.cache["positions"].shape[1] == 64


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "zamba2-7b"))
def test_attention_routes_give_the_same_streams(arch):
    """``dense_attn_impl="kernel"`` (the default; on CPU tensors the
    kernel's plain version stands in) and ``"gather"`` give the same
    streams, for a decoder's layers and a hybrid's shared block."""
    _, _, tcfg, tp = _pair(arch)
    rows = _rows([9, 12], seed=5, vocab=tcfg.vocab_size)
    out = []
    for impl in ("kernel", "gather"):
        eng = Engine(tcfg, tp, cache_kind="dense", device="cpu", max_batch=2,
                     max_len=32, dense_attn_impl=impl)
        out.append(_streams(eng, rows, False))
    assert out[0] == out[1]


@pytest.mark.parametrize("chunk", [0, 4])
def test_prefill_scans_through_the_ssd_op(monkeypatch, chunk):
    """A dense engine's prefill scans from the zero state through
    ``ops.ssd`` (the SSD kernel's route; on CPU tensors its plain
    version stands in), once per Mamba2 layer per admission; a chunked
    prefill's extensions continue from the state, which ``ops.ssd``
    hands to ``ssd_chunked``."""
    _, _, tcfg, tp = _pair("mamba2-780m")
    calls = []
    real = OPS.ssd

    def counted(x, dt, A, B, C, chunk=128, initial_state=None):
        calls.append(initial_state is None)
        return real(x, dt, A, B, C, chunk, initial_state)

    monkeypatch.setattr(OPS, "ssd", counted)
    rows = _rows([9, 12], seed=5, vocab=tcfg.vocab_size, n=3)
    eng = Engine(tcfg, tp, cache_kind="dense", device="cpu", max_batch=2,
                 max_len=32, prefill_chunk=chunk)
    _streams(eng, rows, False)
    L = tcfg.num_layers
    assert calls.count(True) == 2 * L
    # chunk 4: 9 tokens = 4 + extensions of 4 and 1 (a one-token
    # extension steps the recurrence), 12 = 4 + 4 + 4
    assert calls.count(False) == (3 * L if chunk else 0)


def test_one_host_sync_per_steady_step():
    _, _, tcfg, tp = _pair("zamba2-7b")
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


def test_dense_engine_refuses_pool_operations():
    """Module scaling and migration target the pool: a dense engine
    refuses them with the reference's ValueErrors; it has no block size
    and no prefix keys."""
    _, _, tcfg, tp = _pair("mamba2-780m")
    eng = Engine(tcfg, tp, cache_kind="dense", device="cpu")
    assert eng.block_size == 0 and eng.prefix_keys() == set()
    assert eng.prefix_stats()["hits"] == 0
    with pytest.raises(ValueError, match="dense engines"):
        eng.apply_plan([1] * tcfg.num_layers)
    for op, args in (("pause_request", (0,)), ("resume_request", ({},)),
                     ("snapshot_request", (0,)), ("prepare_resume", ({},))):
        with pytest.raises(ValueError, match="paged"):
            getattr(eng, op)(*args)
