"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""
import jax
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors in these tests are tiny: one intra-op thread
    keeps the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit(fn, *args, **kwargs):
    """Run a reference function under one jit: compiling it whole is
    several times faster than JAX's op-by-op eager dispatch."""
    return jax.jit(lambda: fn(*args, **kwargs))()


@pytest.fixture(autouse=False)
def partitionable_threefry():
    """The port reproduces JAX's random bits as JAX 0.9 draws them by
    default, with jax_threefry_partitionable on; older JAX releases need
    it set."""
    with jax.threefry_partitionable(True):
        yield


def tiny_pair(arch: str = "tinyllama-1.1b"):
    """(jax cfg, jax params, port cfg, port params): ``arch.reduced()``
    with fp32 weights from the reference's ``init_params``, bridged to
    the port on the CPU."""
    import numpy as np
    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config

    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = jit(JT.init_params, jcfg, jax.random.PRNGKey(0), "float32")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def specs(rows, *, jax_side: bool):
    """RequestSpecs of one package from rows of (rid, prompt, max_tokens,
    temperature, top_k, seed)."""
    if jax_side:
        from repro.serving.request import RequestSpec, SamplingParams
    else:
        from repro_torch.serving.request import RequestSpec, SamplingParams
    return [RequestSpec(rid=rid, prompt=prompt, max_tokens=n,
                        sampling=SamplingParams(temperature=t, top_k=k,
                                                seed=seed))
            for rid, prompt, n, t, k, seed in rows]


def jax_solo_streams(jcfg, jp, rows, *, block_size: int = 8,
                     max_len: int = 64):
    """The unmigrated reference: each request alone on a fresh JAX paged
    engine. rid -> generated tokens."""
    from repro.serving.engine import Engine

    out = {}
    for spec in specs(rows, jax_side=True):
        e = Engine(jcfg, jp, max_batch=1, max_len=max_len,
                   cache_kind="paged", block_size=block_size)
        e.submit(spec)
        out[spec.rid] = e.run_until_done()[0].generated
    return out
