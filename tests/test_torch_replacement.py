"""Port parity, re-placement of a leaf from any placement to any other
(``core.migration.migrate_by_path``) against the reference's
``jax.device_put`` under a ``NamedSharding``: one subprocess runs the
reference's ``migrate_by_path`` / ``migrate_paged_pool`` on 4 forced
host devices (``replication_mesh(4)`` and ``replication_mesh(2)``) and
writes each device's shard; the port runs the same calls on W = 4 and
W = 2 thread-ranks, each rank's tensor bit-equal to its device's shard.
Then the plan (``replacement_plan``) on its own, and what a rank holds
and allocates: only the part of its new block it lacked is received, a
``meta`` placeholder never takes a whole-size buffer, a replicated leaf
keeps its storage, a shape that contradicts the recorded placement
raises."""
import dataclasses
import itertools
import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config
from repro_torch.core import migration as MIG
from repro_torch.serving import paged_kv as PK
from test_torch_replication import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
POOL = dict(max_batch=2, n_blocks=6, block_size=8, max_len=32)

#: name -> (shape, dtype, placements applied one after another); a
#: placement is a list of entries (None, an axis name or a list of them)
CASES = {
    "whole_to_r0": ((4, 8), "float32", [[None, "r0"]]),
    "whole_to_r1": ((4, 8), "float32", [[None, "r1"]]),
    "whole_to_r0r1": ((2, 3, 8), "float32", [[None, None, ["r0", "r1"]]]),
    "split_to_replicated": ((2, 3, 8), "int32", [[None, None, "r0"], []]),
    "dim_a_to_dim_b": ((4, 8), "bfloat16", [["r0", None], [None, "r0"]]),
    "r0_to_r1": ((4, 8), "float32", [[None, "r0"], [None, "r1"]]),
    "mixed": ((4, 8), "float32", [["r0", "r1"], [["r1", "r0"], None],
                                  [None, "r0"], []]),
    "pool_kv_heads": (None, "bfloat16", [[None, None, "r0"], []]),
}


def _axes(spec):
    return {a for e in spec for a in ([e] if isinstance(e, str) else e or [])}


def _runs(case, W):
    return W == 4 or "r1" not in set().union(*map(_axes, CASES[case][2]))


def _input(case):
    shape, dtype, _ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    if shape is None:   # the reduced config's pool: k, v (and its scratch block)
        cfg = get_config(ARCH).reduced()
        shape = (2, cfg.num_layers, POOL["n_blocks"] + 1, cfg.num_kv_heads,
                 POOL["block_size"], cfg.resolved_head_dim)
    if dtype == "int32":
        return np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    return rng.normal(size=shape).astype(np.float32).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, ml_dtypes, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.core import migration as M
from repro.core.replication import replication_mesh
from repro.serving import paged_kv as PK

cases, pool = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out_path, in_path = sys.argv[3], sys.argv[4]
inputs, out = np.load(in_path), {}

def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a

def spec(p):
    return P(*[tuple(e) if isinstance(e, list) else e for e in p])

for name, W, steps in cases:
    x = inputs[name]
    if x.dtype == np.uint16:
        x = x.view(ml_dtypes.bfloat16)
    mesh = replication_mesh(W)
    order = list(mesh.devices.flat)
    if name.startswith("pool"):   # the port's pool has a scratch block more
        st = PK.init_paged(get_config("tinyllama-1.1b").reduced(), pool["max_batch"],
                           pool["n_blocks"] + 1, block_size=pool["block_size"],
                           dtype="bfloat16", max_len=pool["max_len"])
        st.k, st.v = jnp.asarray(x[0]), jnp.asarray(x[1])
    else:
        tree = {"w": jnp.asarray(x)}
    for i, p in enumerate(steps):
        if name.startswith("pool"):
            st, cost = M.migrate_paged_pool(st, spec(p), mesh)
            arrays = {"k": st.k, "v": st.v}
        else:
            tree, cost = M.migrate_by_path(tree, "^w$", spec(p), mesh)
            arrays = tree
        out[f"{name}/{W}/{i}/bytes"] = np.int64(cost.bytes_moved)
        for key, arr in arrays.items():
            for shard in arr.addressable_shards:
                r = order.index(shard.device)
                out[f"{name}/{W}/{i}/{key}/{r}"] = bits(shard.data)
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's shards on every device of the reference's meshes of
    4 and 2 devices, from one subprocess."""
    d = tmp_path_factory.mktemp("replacement")
    inputs = {}
    for case in CASES:
        x = _input(case)
        inputs[case] = x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x
    np.savez(d / "in.npz", **inputs)
    cases = [(c, W, CASES[c][2]) for c in CASES for W in (4, 2) if _runs(c, W)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps(cases), json.dumps(POOL),
         str(d / "out.npz"), str(d / "in.npz")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _spec(p):
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


def _bits(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("case,W", [(c, W) for c in sorted(CASES)
                                    for W in (4, 2) if _runs(c, W)])
def test_replacement_matches_device_put(reference, case, W):
    """The placements of ``case`` applied one after another from a leaf
    whole on rank 0 (other ranks hold a ``meta`` placeholder, or for the
    pool a whole-size one): after each, every rank's tensor is bit-equal
    to the reference's shard on the same device, ``bytes_moved`` is the
    reference's, and the bytes each rank received are the plan's."""
    _, _, steps = CASES[case]
    x = _input(case)
    pool = case.startswith("pool")

    def rank(group):
        mine = _torch(x)
        if pool:
            st = PK.init_paged(get_config(ARCH).reduced(), POOL["max_batch"],
                               POOL["n_blocks"], block_size=POOL["block_size"],
                               dtype="bfloat16", max_len=POOL["max_len"],
                               device="cpu")
            if group.rank == 0:
                st.k, st.v = mine[0], mine[1]
        else:
            tree = {"w": mine if group.rank == 0 else mine.to("meta")}
        got = []
        for p in steps:
            if pool:
                planned = MIG.planned_bytes({"k": st.k, "v": st.v}, "^(k|v)$",
                                            _spec(p), W, group.rank)
                before = group.bytes_received
                st, cost = MIG.migrate_paged_pool(st, _spec(p), group)
                arrays = {"k": st.k, "v": st.v}
            else:
                planned = MIG.planned_bytes(tree, "^w$", _spec(p), W, group.rank)
                before = group.bytes_received
                tree, cost = MIG.migrate_by_path(tree, "^w$", _spec(p), group)
                arrays = tree
            got.append((cost.bytes_moved, {k: _bits(v) for k, v in arrays.items()},
                        group.bytes_received - before, planned))
        return got

    for r, got in enumerate(run_ranks(W, rank)):
        for i, (moved, arrays, received, planned) in enumerate(got):
            assert moved == reference[f"{case}/{W}/{i}/bytes"]
            assert received == planned
            for key, bits in arrays.items():
                want = reference[f"{case}/{W}/{i}/{key}/{r}"]
                assert bits.shape == want.shape and np.array_equal(bits, want), (
                    case, W, i, key, r)


def _all_specs(ndim, names):
    """Every placement of an ``ndim`` tensor over the axes ``names``:
    each axis unused or on one dim, in either order among a dim's."""
    out = set()
    for dims in itertools.product(range(-1, ndim), repeat=len(names)):
        for order in itertools.permutations(names):
            spec = [[] for _ in range(ndim)]
            for a in order:
                d = dims[names.index(a)]
                if d >= 0:
                    spec[d].append(a)
            out.add(tuple(tuple(e) for e in spec))
    return sorted(out)


def test_plan_receives_only_what_is_lacking():
    """Over every pair of placements of a (4, 8) leaf on 4 ranks, and from
    whole on rank 0: each rank's pieces tile exactly the part of its new
    block it did not hold (so it receives that many elements and no
    more), each from a rank that holds it, with coordinate 0 on the
    source's unused axes; a plan where every rank holds its new block
    sends nothing."""
    shape = (4, 8)
    specs = _all_specs(2, ["r0", "r1"])
    for src, dst in itertools.product([None] + specs, specs):
        plan = MIG.replacement_plan(shape, src, dst, 4)
        used = set() if src is None else {a for e in src for a in e}
        for r in range(4):
            need, have = plan.after[r], plan.before[r]
            cover = np.zeros(shape, np.int32)
            cover[tuple(slice(*b) for b in need)] = 1
            if have is not None:
                cover[tuple(slice(*b) for b in have)] = 0
            lacking = int(cover.sum())
            got = np.zeros(shape, np.int32)
            for s, q, block in plan.pieces:
                if q != r:
                    continue
                assert plan.before[s] is not None and s != r
                idx = tuple(slice(*b) for b in block)
                assert all(a0 <= b0 and b1 <= a1 for (a0, a1), (b0, b1)
                           in zip(plan.before[s], block))
                got[idx] += 1
                unused = [i for i, a in enumerate(("r0", "r1")) if a not in used]
                assert all(not (s >> (1 - i)) & 1 for i in unused) or src is None
                assert src is not None or s == 0
            assert np.array_equal(got, cover), (src, dst, r)
            assert plan.received(r) == lacking
        if src is not None and all(
                all(h0 <= n0 and n1 <= h1 for (h0, h1), (n0, n1) in zip(b, a))
                for b, a in zip(plan.before, plan.after)):
            assert plan.pieces == ()
    # split over r0 back to replicated: the holders of rank 0's lacking half
    # are ranks 2 and 3, and rank 2 (r1 = 0) sends it
    plan = MIG.replacement_plan(shape, ((), ("r0",)), (), 4)
    assert sorted((s, q) for s, q, _ in plan.pieces) == [
        (0, 2), (0, 3), (2, 0), (2, 1)]


class Largest(TorchDispatchMode):
    """The largest storage any op makes while installed (this thread's)."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.most = max(self.most, t.untyped_storage().nbytes())
        return out


@pytest.mark.parametrize("W,spec", [(2, (None, "r0")), (4, (("r0", "r1"),)),
                                    (4, ("r1", None))])
def test_meta_placeholder_receives_its_shard_only(W, spec):
    """Ranks above 0 hold a ``meta`` placeholder: each allocates its
    shard alone (received in place, no buffer beside it), and receives
    the shard's bytes, in one all-to-all; every shard has storage of its
    own, and the whole leaf comes back bit-equal on every rank."""
    x = torch.arange(64, dtype=torch.float32).view(8, 8)
    after = MIG.replacement_plan(x.shape, None, spec, W).after

    def rank(group):
        shard = 4 * np.prod([b - a for a, b in after[group.rank]])
        leaf = x.clone() if group.rank == 0 else torch.empty(8, 8, device="meta")
        with Largest() as seen:
            tree, _ = MIG.migrate_by_path({"w": leaf}, "w", spec, group)
        t = tree["w"]
        own = t.untyped_storage().nbytes() == t.numel() * 4 == shard
        counts, received = dict(group.counts), group.bytes_received
        back, _ = MIG.migrate_by_path(tree, "w", (), group)
        return (seen.most, own, counts, received, torch.equal(back["w"], x),
                group.bytes_received - received, shard)

    for r, (most, own, counts, received, whole, back, shard) in enumerate(
            run_ranks(W, rank)):
        assert own and whole
        assert counts == {"all-to-all": 1}
        assert received == (0 if r == 0 else shard)
        assert back == x.numel() * 4 - shard
        if r:
            assert most == shard


def test_already_held_sends_nothing():
    """Replicated -> split, and a split re-placed as it is: every rank
    holds its new block, so no collective runs and nothing is received;
    split -> a finer split keeps a copy of the part in storage of its
    own, again with no collective."""
    x = torch.arange(32, dtype=torch.float32).view(4, 8)

    def rank(group):
        leaf = x.clone() if group.rank == 0 else torch.zeros(4, 8)
        rep, _ = MIG.migrate_by_path({"w": leaf}, "w", (), group)
        base = dict(group.counts), group.bytes_received
        half, _ = MIG.migrate_by_path(rep, "w", (None, "r0"), group)
        same, _ = MIG.migrate_by_path(half, "w", (None, "r0"), group)
        quarter, _ = MIG.migrate_by_path(same, "w", (None, ("r0", "r1")), group)
        q = quarter["w"]
        return (base, dict(group.counts), group.bytes_received,
                same["w"] is half["w"],
                q.untyped_storage().nbytes() == q.numel() * 4,
                torch.equal(q, x[:, 2 * group.rank:2 * group.rank + 2]))

    for base, counts, received, kept, own, equal in run_ranks(4, rank):
        assert counts == base[0] and received == base[1]
        assert kept and own and equal


def test_replicated_keeps_storage():
    """Whole on rank 0 -> replicated keeps rank 0's storage and fills a
    whole-size placeholder in place (a pool's graphs keep their
    addresses); replicated -> replicated moves nothing and keeps every
    rank's tensor."""
    x = torch.arange(32, dtype=torch.float32).view(4, 8)

    def rank(group):
        leaf = x.clone() if group.rank == 0 else torch.zeros(4, 8)
        ptr = leaf.data_ptr()
        rep, cost = MIG.migrate_by_path({"w": leaf}, "w", (), group)
        n = dict(group.counts)
        again, _ = MIG.migrate_by_path(rep, "w", (), group)
        return (rep["w"] is leaf and leaf.data_ptr() == ptr,
                again["w"] is leaf, n, dict(group.counts),
                torch.equal(leaf, x), MIG.placement_of(leaf), cost.bytes_moved)

    for kept, again, n, counts, equal, placed, moved in run_ranks(2, rank):
        assert kept and again and equal and moved == 128
        assert n == counts == {"all-to-all": 1}
        assert placed == MIG.Placement(((), ()), 2, (4, 8))


def test_contradicting_shape_raises():
    """A tensor whose shape no longer fits its recorded placement (here
    resized in place), or re-placed over a group of another size,
    raises rather than moving the wrong block."""
    x = torch.arange(32, dtype=torch.float32).view(4, 8)

    def rank(group):
        leaf = x.clone() if group.rank == 0 else torch.empty(4, 8, device="meta")
        tree, _ = MIG.migrate_by_path({"w": leaf}, "w", (None, "r0"), group)
        t = tree["w"]
        assert MIG.placement_of(t) == MIG.Placement(((), ("r0",)), 2, (4, 8))
        solo = dataclasses.replace(group, pg=None, rank=0, size=1)
        with pytest.raises(ValueError, match="group of 1"):
            MIG.migrate_by_path(tree, "w", (), solo)
        t.resize_(4, 8)
        with pytest.raises(ValueError, match="contradicts its placement"):
            MIG.migrate_by_path(tree, "w", (), group)
        with pytest.raises(ValueError, match="used twice"):
            MIG.replacement_plan((4, 8), None, ("r0", "r0"), 2)
        with pytest.raises(ValueError, match="does not split"):
            MIG.replacement_plan((3, 8), None, ("r0",), 2)
        return True

    assert run_ranks(2, rank) == [True, True]
