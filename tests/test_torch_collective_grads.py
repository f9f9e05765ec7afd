"""The port's differentiable collectives (``parallel.mesh``): each
collective's backward, on an axis of 1 and of 2 ranks (threads of the
test process, ``_torch_mesh.run_mesh``), against the gradient of the
same global function computed unsharded by autograd, in float64.

The convention (``parallel.mesh``'s docstring): a replicated output
carries the whole cotangent on every rank, so ``psum`` and
``all_gather`` pass it through (identity, slice); where each rank's
term of the objective differs, ``psum(grad="psum")`` and
``all_gather(grad="reduce_scatter")`` sum the ranks' cotangents; the
all-to-all's backward is itself; ``enter`` is the identity whose
backward sums over the axis. Each test also counts the backward's
collectives (``RankMesh.tally``)."""
import numpy as np
import pytest
import torch

from _torch_mesh import run_mesh
from _torch_parity import one_torch_thread  # noqa: F401

AXES = ("x",)
SHAPE = (3, 4)


def _draw(n, seed, shape=SHAPE):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal(shape)) for _ in range(n)]


def _rank_grad(n, fn):
    """Each rank's (value, gradient of its input, backward tally) for
    ``fn(mesh, x) -> objective``, x drawn per rank (seed 1)."""
    xs = _draw(n, 1)

    def rank(mesh):
        x = xs[mesh.rank].clone().requires_grad_()
        mesh.reset_tally()
        out = fn(mesh, x)
        (g,) = torch.autograd.grad(out, x)
        return g, mesh.tally()["backward"]

    return xs, run_mesh((n,), rank, axes=AXES)


def _global_grads(xs, fn):
    """Autograd of the global objective ``fn(list of inputs)``."""
    xs = [x.clone().requires_grad_() for x in xs]
    return torch.autograd.grad(fn(xs), xs)


def _check(got, want, n, bwd, kind, count):
    for (g, _), w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    want_bwd = {kind: count} if n > 1 and count else {}
    assert {k: v["count"] for k, v in got[0][1].items()} == want_bwd, bwd


@pytest.mark.parametrize("n", [1, 2])
def test_psum_identity_backward(n):
    """A replicated sum, one objective (the same cotangent c on every
    rank): each rank's input gets c."""
    (c,) = _draw(1, 2)
    xs, got = _rank_grad(n, lambda m, x: (m.psum(x, "x") * c).sum())
    want = _global_grads(xs, lambda v: (sum(v) * c).sum())
    _check(got, want, n, "psum", "all-reduce", 0)


@pytest.mark.parametrize("n", [1, 2])
def test_psum_psum_backward(n):
    """Each rank's own term <psum(x), c_r> of a summed objective: the
    input's gradient is the sum of every rank's cotangent."""
    cs = _draw(n, 2)
    xs, got = _rank_grad(
        n, lambda m, x: (m.psum(x, "x", grad="psum") * cs[m.rank]).sum())
    want = _global_grads(xs, lambda v: sum((sum(v) * c).sum() for c in cs))
    _check(got, want, n, "psum", "all-reduce", 1)


@pytest.mark.parametrize("n", [1, 2])
def test_all_gather_slice_backward(n):
    (c,) = _draw(1, 2, (SHAPE[0], n * SHAPE[1]))
    xs, got = _rank_grad(n, lambda m, x: (m.all_gather(x, "x", 1) * c).sum())
    want = _global_grads(xs, lambda v: (torch.cat(v, 1) * c).sum())
    _check(got, want, n, "all_gather", "reduce-scatter", 0)


@pytest.mark.parametrize("n", [1, 2])
def test_all_gather_reduce_scatter_backward(n):
    cs = _draw(n, 2, (n * SHAPE[0], SHAPE[1]))
    xs, got = _rank_grad(
        n, lambda m, x: (m.all_gather(x, "x", 0, grad="reduce_scatter")
                         * cs[m.rank]).sum())
    want = _global_grads(
        xs, lambda v: sum((torch.cat(v, 0) * c).sum() for c in cs))
    _check(got, want, n, "all_gather", "reduce-scatter", 1)


@pytest.mark.parametrize("n", [1, 2])
def test_all_to_all_backward(n):
    """x_r [n, ...] holds a row per destination; y_r[s] = x_s[r], and
    each rank's term is <y_r, c_r>."""
    cs = _draw(n, 2, (n, *SHAPE))

    def rank(mesh):
        x = _draw(n, 1, (n, *SHAPE))[mesh.rank].requires_grad_()
        mesh.reset_tally()
        y = mesh.all_to_all(x, "x")
        (g,) = torch.autograd.grad((y * cs[mesh.rank]).sum(), x)
        return g, mesh.tally()["backward"]

    got = run_mesh((n,), rank, axes=AXES)
    want = _global_grads(
        _draw(n, 1, (n, *SHAPE)),
        lambda v: sum((torch.stack([v[s][r] for s in range(n)]) * cs[r]).sum()
                      for r in range(n)))
    _check(got, want, n, "all_to_all", "all-to-all", 1)


@pytest.mark.parametrize("n", [1, 2])
def test_enter_psum_backward(n):
    """A replicated input (the same x on every rank) entering a split
    computation y_r = x * w_r, objective sum_r <y_r, c_r>: the input's
    whole gradient, on every rank."""
    ws, cs = _draw(n, 3), _draw(n, 4)
    (x0,) = _draw(1, 1)

    def rank(mesh):
        x = x0.clone().requires_grad_()
        mesh.reset_tally()
        y = mesh.enter(x, "x") * ws[mesh.rank]
        (g,) = torch.autograd.grad((y * cs[mesh.rank]).sum(), x)
        return g, mesh.tally()["backward"]

    got = run_mesh((n,), rank, axes=AXES)
    x = x0.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        sum((x * w * c).sum() for w, c in zip(ws, cs)), x)
    _check(got, [want] * n, n, "enter", "all-reduce", 1)


def test_pmax_has_no_backward():
    def rank(mesh):
        x = _draw(1, 1)[0].requires_grad_()
        y = mesh.pmax(x, "x")
        with pytest.raises(NotImplementedError, match="no backward"):
            torch.autograd.grad(y.sum(), x)
        return True

    assert all(run_mesh((2,), rank, axes=AXES))


def test_psum_backward_counts_on_two_axes():
    """On a (2, 2) mesh a psum over one axis with a psum backward reduces
    over that axis's line only: ranks that share the other coordinate."""
    cs = _draw(4, 2)
    xs = _draw(4, 1)

    def rank(mesh):
        x = xs[mesh.rank].clone().requires_grad_()
        y = mesh.psum(x, "model", grad="psum")
        (g,) = torch.autograd.grad((y * cs[mesh.rank]).sum(), x)
        return g

    got = run_mesh((2, 2), rank)
    for r in range(4):
        line = [r - r % 2, r - r % 2 + 1]       # the model line of rank r
        torch.testing.assert_close(got[r], cs[line[0]] + cs[line[1]])
