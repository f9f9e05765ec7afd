"""Port parity, the sharding rules: ``repro_torch.parallel.sharding``'s
rule tables and spec trees against ``repro.parallel.sharding`` for every
config, on meshes from 1x2 to the reference's 16x16 and 2x16x16 pod.
The reference side reads stand-in meshes and ``jax.eval_shape`` trees;
the port side reads the same stand-ins and meta tensors of the same
shapes (its own ``init_cache`` on the meta device), so no weight is
allocated. A spec is the port's tuple and ``tuple(PartitionSpec)`` on
the reference's side. Then ``shard_params``: each rank's slices of the
reference's numpy arrays."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.models import transformer as JT
from repro.parallel import sharding as JSH
from repro_torch.bridge import shard_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import RankMesh
from _torch_mesh import fake_mesh
from _torch_parity import jit

MESHES = {
    "1x2": ((1, 2), ("data", "model")),
    "2x1": ((2, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
CASES = [(a, m) for a in list_archs() for m in MESHES]


def _plain(tree):
    """A reference spec tree as nested dicts of tuples."""
    return jax.tree_util.tree_map(tuple, tree,
                                  is_leaf=lambda x: isinstance(x, P))


def _meta(shapes):
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)


@functools.cache
def _shapes(arch):
    """The reference's param and cache shape trees of ``arch`` (one
    ``eval_shape`` each, shared by every mesh)."""
    cfg = jax_config(arch)
    params = jax.eval_shape(
        lambda: JT.init_params(cfg, jax.random.PRNGKey(0), "bfloat16"))
    cache = jax.eval_shape(lambda: JT.init_cache(cfg, 2, 16, "bfloat16"))
    return params, cache


@pytest.mark.parametrize("arch,mesh", CASES)
def test_rules_match_reference(arch, mesh):
    """``rules_for`` and ``long_context_rules``: the same table."""
    fm = fake_mesh(*MESHES[mesh])
    jcfg, tcfg = jax_config(arch), get_config(arch)
    assert SH.rules_for(tcfg, fm) == JSH.rules_for(jcfg, fm)
    assert SH.long_context_rules(tcfg, fm) == JSH.long_context_rules(jcfg,
                                                                      fm)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_specs_match_reference(arch, mesh):
    """``param_specs`` over the params tree, ``cache_specs`` over the
    port's own meta cache (the reference's tree, key for key) under both
    rule tables, ``batch_specs`` and ``opt_state_specs``."""
    fm = fake_mesh(*MESHES[mesh])
    jcfg, tcfg = jax_config(arch), get_config(arch)
    params, cache = _shapes(arch)
    tcache = T.init_cache(tcfg, 2, 16, "bfloat16", device="meta")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tcache) == \
        jax.tree_util.tree_map(lambda s: tuple(s.shape), cache)
    for make in ("rules_for", "long_context_rules"):
        jrules = getattr(JSH, make)(jcfg, fm)
        trules = getattr(SH, make)(tcfg, fm)
        jspecs = _plain(JSH.param_specs(jcfg, params, jrules, fm))
        tspecs = SH.param_specs(tcfg, _meta(params), trules, fm)
        assert tspecs == jspecs
        assert SH.cache_specs(tcache, trules) == _plain(
            JSH.cache_specs(cache, jrules))
        assert SH.batch_specs(trules, True) == _plain(
            JSH.batch_specs(jrules, True))
        assert SH.opt_state_specs(tspecs) == _plain(
            JSH.opt_state_specs(JSH.param_specs(jcfg, params, jrules, fm)))


@functools.cache
def _reduced_params(arch):
    return jax.tree_util.tree_map(
        np.asarray, jit(JT.init_params, jax_config(arch).reduced(),
                        jax.random.PRNGKey(0), "float32"))


def _ref_slice(a, spec, coords, mesh_shape, axes):
    """This rank's block of a numpy array under a reference spec, by
    ``np.split`` over each dim's axes in turn (first axis major)."""
    size = dict(zip(axes, mesh_shape))
    at = dict(zip(axes, coords))
    for dim, names in enumerate(tuple(spec)):
        if names is None:
            continue
        for name in names if isinstance(names, tuple) else (names,):
            a = np.split(a, size[name], axis=dim)[at[name]]
    return a


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "minicpm3-4b"])
@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_shard_params_slices(arch, mesh):
    """Every rank's ``shard_params`` leaf (and ``shard_from_numpy``'s
    tensor) equals the numpy slice of the reference's array that its
    spec gives, in storage of its own."""
    shape, axes = MESHES[mesh]
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = _reduced_params(arch)
    fm = fake_mesh(shape, axes)
    jspecs = JSH.param_specs(jcfg, jp, JSH.rules_for(jcfg, fm), fm)
    specs = SH.param_specs(tcfg, jp, SH.rules_for(tcfg, fm), fm)
    assert specs == _plain(jspecs)
    n_split = 0
    for r in range(int(np.prod(shape))):
        mesh_r = RankMesh(axes, shape, r, "cpu",
                          {a: object() for a, n in zip(axes, shape) if n > 1})
        got = SH.shard_params(jp, specs, mesh_r)
        tens = shard_from_numpy(jp, specs, mesh_r, "cpu")

        def check(path, leaf, spec):
            want = _ref_slice(leaf, spec, mesh_r.coords, shape, axes)
            part = got
            t = tens
            for k in path:
                part, t = part[k.key], t[k.key]
            np.testing.assert_array_equal(part, want)
            assert not np.shares_memory(part, leaf)
            np.testing.assert_array_equal(t.numpy(), want)
            return part.size < leaf.size

        n_split += sum(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map_with_path(check, jp, jspecs)))
    assert n_split > 0
