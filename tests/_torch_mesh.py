"""Helpers of the port's sharding tests: ranks as threads of the test
process (``run_threads``; meshes with one gloo group per axis line over
one ``HashStore``; no process is spawned), the reference's stand-in and
Auto meshes."""
import datetime
import itertools
import threading
import types

import jax
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import RankMesh

AXES = ("data", "model")
_STORE = dist.HashStore()
_PREFIX = itertools.count()


def run_threads(W, fn, timeout=120):
    """``fn(r)`` for r < W, each on a thread of its own; returns the
    results by rank and re-raises a rank's error. Every rank runs at the
    caller's intra-op thread count: torch sets OpenMP's and MKL's thread
    counts per thread, and a new thread takes the process default (every
    core) until its first parallel op, so ranks that compute the same
    rows would otherwise split their work differently (and a matmul that
    splits its inner dimension differently rounds differently)."""
    n = torch.get_num_threads()
    out, errors = [None] * W, []

    def rank(r):
        try:
            torch.set_num_threads(n)
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(W)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return out


def run_mesh(shape, fn, axes=AXES, timeout=120):
    """``fn(mesh)`` on every rank of a mesh ``shape``, each a thread
    (``run_threads``) with its own ``RankMesh``; returns the results by
    rank and re-raises a rank's error."""
    store = dist.PrefixStore(f"m{next(_PREFIX)}", _STORE)

    def rank(r):
        return fn(RankMesh.build(store, axes, shape, r, "cpu",
                                 datetime.timedelta(seconds=timeout)))

    return run_threads(int(np.prod(shape)), rank, timeout)


def fake_mesh(shape, axes=AXES):
    """The reference's stand-in mesh (its tests' ``fake_mesh``): the
    rule and spec functions read only the names and ``devices.shape``."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def auto_mesh():
    """A 1x1 mesh of Auto axes, on which the reference's sharded code
    runs in-process on the CPU (``jax.make_mesh`` builds Explicit axes,
    on which it fails)."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), AXES)


def rows(mesh, rules, B):
    """This rank's slice of a batch of B rows under ``rules["batch"]``."""
    n, i = mesh.axes_size(rules["batch"]), mesh.axes_index(rules["batch"])
    return slice(i * (B // n), (i + 1) * (B // n))
