"""Port parity, the serving engine end to end on the CPU: the port's
paged Engine(device="cpu"), under the budget and the phase scheduler,
yields the reference Engine's token streams on the reference's own
continuous-batching, ragged-prompt, backpressure and sliding-window
workloads, greedy and sampled; plus the port's import and device rules."""
import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.request import RequestSpec as JaxSpec
from repro.serving.request import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import replication as R
from repro_torch.serving import paged_kv as PK
from repro_torch.serving.engine import Engine
from repro_torch.serving.instrument import count_host_syncs
from repro_torch.serving.request import RequestSpec, SamplingParams
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config("tinyllama-1.1b").reduced()
    tcfg = get_config("tinyllama-1.1b").reduced()
    jp = jax.jit(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0),
                                        "float32"))()
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces JAX's random bits as JAX 0.9 draws them by
    default, with jax_threefry_partitionable on; older JAX releases need
    it set."""
    with jax.threefry_partitionable(True):
        yield


def _prompts(sizes, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=s).astype(np.int32) for s in sizes]


def _cb_prompts():
    base = _prompts([40, 72, 24], seed=1)
    return base + [np.concatenate([base[0][:24], base[2]])]  # shares req 0


# name: (prompts, engine kwargs, max_new tokens)
WORKLOADS = {
    "continuous_batching": (
        _cb_prompts(), dict(max_batch=3, max_len=128, block_size=8,
                            token_budget=24), 5),
    "ragged": (_prompts([8, 8, 5, 11], seed=5, vocab=512),
               dict(max_batch=2, max_len=64, block_size=8), 6),
    "backpressure": (_prompts([8, 8, 5, 11], seed=6, vocab=512),
                     dict(max_batch=2, max_len=64, block_size=8,
                          n_blocks=4), 12),
}


def _run(engine, spec_cls, sampling_cls, prompts, max_new, temp, top_k):
    for i, p in enumerate(prompts):
        engine.submit(spec_cls(
            rid=i, prompt=p, max_tokens=max_new,
            sampling=sampling_cls(temperature=temp, top_k=top_k,
                                  seed=100 + i)))
    return {r.rid: list(r.generated) for r in engine.run_until_done()}


_REFERENCE = {}


def _both(tiny, key, prompts, max_new, temp=0.0, top_k=0, cfg_changes=None,
          scheduler="budget", **kw):
    """The reference's streams and the port's, and the port's engine.
    The reference runs once per workload (``key``), under the phase
    scheduler: the JAX package's own tests hold its budget and phase
    loops token-identical (test_continuous_batching.py), so one reference
    run serves the port under both schedulers."""
    jcfg, jp, tcfg, tp = tiny
    if cfg_changes:
        jcfg = dataclasses.replace(jcfg, **cfg_changes)
        tcfg = dataclasses.replace(tcfg, **cfg_changes)
    if key not in _REFERENCE:
        ref = JaxEngine(jcfg, jp, cache_kind="paged", scheduler="phase", **kw)
        _REFERENCE[key] = _run(ref, JaxSpec, JaxSampling, prompts, max_new,
                               temp, top_k)
    eng = Engine(tcfg, tp, device="cpu", scheduler=scheduler, **kw)
    got = _run(eng, RequestSpec, SamplingParams, prompts, max_new, temp,
               top_k)
    return _REFERENCE[key], got, eng


@pytest.mark.parametrize("scheduler", ["budget", "phase"])
@pytest.mark.parametrize("sharing", [False, True])
@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.8, 8)])
def test_continuous_batching_streams_identical(tiny, scheduler, sharing,
                                               temp, top_k):
    """Prompts 40/72/24 plus one sharing a prefix, budget 24, block 8:
    chunked prefill, prefix hits (when sharing) and sampled rows."""
    prompts, kw, max_new = WORKLOADS["continuous_batching"]
    want, got, eng = _both(tiny, ("cb", sharing, temp), prompts, max_new,
                           temp, top_k, scheduler=scheduler,
                           prefix_sharing=sharing, **kw)
    assert got == want
    assert eng.pstate.blocks_in_use() == 0
    if sharing:
        assert eng.prefix_stats()["hits"] > 0


@pytest.mark.parametrize("scheduler", ["budget", "phase"])
@pytest.mark.parametrize("name", ["ragged", "backpressure"])
def test_ragged_and_backpressure_streams_identical(tiny, name, scheduler):
    """Ragged prompts 8/8/5/11 across block boundaries; and the same with
    a 4-block pool, where admission waits and decode preempts."""
    prompts, kw, max_new = WORKLOADS[name]
    want, got, eng = _both(tiny, name, prompts, max_new, scheduler=scheduler,
                           **kw)
    assert got == want and len(got) == len(prompts)
    if name == "backpressure":
        assert eng.preempt_count > 0
    assert eng.pstate.blocks_in_use() == 0


@pytest.mark.parametrize("scheduler", ["budget", "phase"])
def test_sliding_window_streams_identical(tiny, scheduler):
    """A 16-token window on 4-token blocks: leading blocks return to the
    pool mid-prefill and mid-decode; the windowed kernel request routes
    to the gather path."""
    prompts = _prompts([40, 56], seed=2)
    want, got, eng = _both(
        tiny, "window", prompts, 6, cfg_changes={"sliding_window": 16},
        scheduler=scheduler, token_budget=16, max_batch=2, max_len=96,
        block_size=4, swa=True)
    assert got == want
    assert eng.pstate.blocks_in_use() == 0


def test_paged_prefill_chunk_streams_identical(tiny):
    """``prefill_chunk``: whole-prompt waves at exact lengths, each
    prefilled in slices of 4 over the throwaway cache (the phase
    scheduler), against the reference's paged engine with the same
    setting."""
    jcfg, jp, tcfg, tp = tiny
    prompts, kw, max_new = WORKLOADS["ragged"]
    kw = dict(kw, scheduler="phase", prefill_chunk=4)
    want = _run(JaxEngine(jcfg, jp, cache_kind="paged", **kw), JaxSpec,
                JaxSampling, prompts, max_new, 0.0, 0)
    got = _run(Engine(tcfg, tp, device="cpu", **kw), RequestSpec,
               SamplingParams, prompts, max_new, 0.0, 0)
    assert got == want


def test_kernel_and_gather_impls_agree(tiny):
    """On the CPU the "kernel" impl is the kernel's plain version; it and
    the gather path give the same streams."""
    _, _, tcfg, tp = tiny
    prompts, kw, max_new = WORKLOADS["continuous_batching"]
    out = {impl: _run(Engine(tcfg, tp, device="cpu", paged_attn_impl=impl,
                             **kw), RequestSpec, SamplingParams, prompts,
                      max_new, 0.8, 8)
           for impl in ("kernel", "gather")}
    assert out["kernel"] == out["gather"]


def test_one_host_sync_per_steady_decode_step(tiny):
    _, _, tcfg, tp = tiny
    eng = Engine(tcfg, tp, device="cpu", max_batch=3, max_len=128,
                 block_size=8)
    for i, p in enumerate(_prompts([9, 17, 30], seed=3)):
        eng.submit(RequestSpec(rid=i, prompt=p, max_tokens=12))
    while eng.queue or eng.prefilling:
        eng.step()
    for _ in range(5):
        n = eng._step_count
        with count_host_syncs() as c:
            eng.step()
        assert eng._step_count == n + 1 and c.n == 1


def test_device_rules(tiny, monkeypatch):
    """No device and no CUDA: the engine refuses rather than silently
    running on the CPU. Out-of-vocab prompt ids are refused at submit."""
    _, _, tcfg, tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tcfg, tp)
    eng = Engine(tcfg, tp, device="cpu")
    with pytest.raises(ValueError, match="prompt ids"):
        eng.submit(RequestSpec(rid=0, prompt=[1, tcfg.vocab_size]))
    with pytest.raises(TypeError):
        eng.submit({"rid": 0, "prompt": [1, 2]})


def test_uncovered_options_raise(tiny, monkeypatch):
    _, _, tcfg, tp = tiny
    # an SSM has nothing to page, and MLA latents and audio cross K/V are
    # not pooled: the reference's ValueError
    for arch in ("mamba2-780m", "minicpm3-4b", "whisper-medium"):
        with pytest.raises(ValueError, match="cache_kind='paged' needs a GQA"):
            Engine(get_config(arch).reduced(), tp, device="cpu")
    eng = Engine(tcfg, tp, device="cpu")
    # without a replication group the engine is its own size-1 group: a
    # plan quantizes to all ones; a group of 2 takes degree 2 (the steps
    # that run it: tests/test_torch_replication.py)
    eng.apply_plan([2] * tcfg.num_layers)
    assert eng._step_degrees == (1,) * tcfg.num_layers
    pair = R.ReplicationGroup(object(), 0, 2, "cpu")
    two = Engine(tcfg, tp, device="cpu", group=pair)
    two.apply_plan([4] * tcfg.num_layers)
    assert two._step_degrees == (2,) * tcfg.num_layers
    with pytest.raises(ValueError, match="device"):
        Engine(tcfg, tp, device="cpu",
               group=R.ReplicationGroup(object(), 0, 2, "meta"))
    with pytest.raises(PK.OutOfBlocks):     # never-fits rejection
        eng.submit(RequestSpec(rid=1, prompt=np.full(200, 3, np.int32)))
        eng.run_until_done()


def test_engine_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.serving.engine, repro_torch.bridge, "
            "repro_torch.core.controller, repro_torch.core.migration, "
            "repro_torch.core.replication, repro_torch.core.scale_up, "
            "repro_torch.core.scale_down, repro_torch.serving.instance, "
            "repro_torch.serving.orchestrator, "
            "repro_torch.serving.transport, "
            "repro_torch.serving.remote_engine, repro_torch.serving.ingress, "
            "repro_torch.launch.pod, repro_torch.launch.serve, "
            "repro_torch.models.moe, repro_torch.serving.kvcache, "
            "repro_torch.serving.workload, repro_torch.serving.simulator, "
            "repro_torch.training.optimizer, repro_torch.training.train, "
            "repro_torch.training.checkpoint, repro_torch.data.pipeline, "
            "repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_no_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
