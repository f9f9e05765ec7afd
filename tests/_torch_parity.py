"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""
import os

# MKL's reproducible mode for this process. MKL reads the variable at its
# first call, so it is set before torch is imported here, and every test
# module is imported before a test runs; ``mkl_branch`` reads back the
# branch MKL took (``test_torch_replication.py::
# test_mkl_runs_its_reproducible_branch``). In MKL's default mode, ranks
# that are threads of one process now and then computed the same rows of
# a layer differently (an attention output 1.6e-4 off its peer rank's),
# failing the 1e-4 gates against the reference; single-threaded MKL, a
# fixed AVX-512 branch and "AUTO,STRICT" did not prevent it (ROADMAP C8).
os.environ.setdefault("MKL_CBWR", "COMPATIBLE")

import ctypes  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

#: ``MKL_CBWR_BRANCH`` (mkl_service.h): the option that asks for the branch
MKL_CBWR_BRANCH = 1
#: ``MKL_CBWR_COMPATIBLE`` (mkl_service.h): the branch ``MKL_CBWR=COMPATIBLE``
#: selects; ``MKL_CBWR_BRANCH_OFF`` (1) where the mode is off
MKL_CBWR_COMPATIBLE = 3


def mkl_branch():
    """The branch of MKL's reproducible mode this process runs, read with
    ``mkl_serv_cbwr_get`` from torch's CPU library (it links MKL in and
    exports MKL's service functions), or None where torch has no MKL."""
    if not torch.backends.mkl.is_available():
        return None
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    get = lib.mkl_serv_cbwr_get
    get.restype, get.argtypes = ctypes.c_int, [ctypes.c_int]
    return get(MKL_CBWR_BRANCH)


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
