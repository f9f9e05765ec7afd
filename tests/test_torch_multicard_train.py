"""Port parity, the sharded train step on four ranks (``chip_multicard.py``
part T at reduced size): four thread-ranks over gloo
(``_torch_mesh.run_mesh``; no process is spawned) run one step of
``training.train`` under sharding rules, each on its shard of weights
drawn by the reference's ``init_params`` and its rows of the batch,
against the reference's UNSHARDED step on the whole batch (one jit per
config, shared by its meshes): tinyllama-1.1b on (1, 4) and (4, 1), and
qwen2-moe-a2.7b on (4, 1) with 12 experts (padded to 16, 4 a rank on
``data``: the scatter dispatch, as at published width). Losses within
1e-5, each rank's shards of the params and of both moments within 1e-4
(relative L2); the step's collectives by phase and kind equal the dry
run's (``launch.dryrun`` on ``RankMesh.dry``) and ``chip_smoke.
p15_predicted``, which is also held to the dry run on (2, 2) and on
part T's llama2-13b case (bf16 params, fp32 moments, (1, 4)) at reduced
size. Last, ``RankMesh``'s collective timing: the host clock on gloo,
CUDA events on NCCL (a stand-in ``ProcessGroupNCCL``, as
``test_torch_multicard.py``'s)."""
import dataclasses
import functools
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch.bridge import shard_from_numpy
from repro_torch.configs import InputShape, get_config
from repro_torch.data import pipeline as TDP
from repro_torch.launch import dryrun as DR
from repro_torch.models import transformer as T
from repro_torch.parallel import mesh as M
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import RankMesh
from repro_torch.training import optimizer as TOPT
from repro_torch.training import train as TTR
from _torch_mesh import AXES, run_mesh
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_sharded import (OPT_KW, flat, global_batch, pair, ref_train, rel,
                            shard_index)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

#: name -> (arch, config changes)
CONFIGS = {"tinyllama": ("tinyllama-1.1b", ()),
           "qwen2-moe": ("qwen2-moe-a2.7b", (("num_experts", 12),))}
DATA = dict(seq_len=16, global_batch=4)


@functools.cache
def _reference(name):
    """The reference's unsharded loss and one train step (params and
    moments after it) on the whole batch 0."""
    arch, changes = CONFIGS[name]
    jcfg, np_params, tcfg = pair(arch, changes)
    return ref_train(jcfg, np_params, global_batch(tcfg, TDP.DataConfig(**DATA)))


def _dry(cfg, part_shape, rank, dtype="float32", extra=None):
    """The dry run's collectives by phase and kind of ``rank``'s train
    step on ``part_shape`` (meta tensors, no group)."""
    _, rules, step, args = DR.input_specs(
        cfg.name, InputShape("t", "train", DATA["seq_len"], DATA["global_batch"]),
        RankMesh.dry(AXES, part_shape, rank), dtype=dtype, moments_dtype="float32",
        rules_override=extra, cfg_override=cfg, remat=False)
    _, tally, _ = DR.run_step(rules, step, args)
    return CS.tally_counts(tally)


def _rank_step(name, mesh):
    """This rank's step under rules: its losses, its shards of the params
    and both moments after it (each with its slice of the global leaf)
    and the step's collectives by phase and kind."""
    arch, changes = CONFIGS[name]
    _, np_params, tcfg = pair(arch, changes)
    rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
    specs = SH.param_specs(tcfg, np_params, rules, mesh)
    batch = next(TDP.sharded_batches(tcfg, TDP.DataConfig(**DATA), mesh,
                                     SH.batch_specs(rules)["tokens"], 1))
    p = shard_from_numpy(np_params, specs, mesh, "cpu")
    o = TOPT.init_opt_state(p)
    mesh.reset_tally()
    with SH.use_rules(rules):
        p, o, m = TTR.make_train_step(tcfg, TOPT.OptimizerConfig(**OPT_KW))(p, o, batch)
    where = {k: shard_index(v.shape, s, mesh)
             for (k, v), (_, s) in zip(flat(np_params).items(), TOPT.tree_items(specs))}
    return {"loss": float(m["loss"]), "total": float(m["total_loss"]),
            "trees": {"params": flat(p), "mu": flat(o["mu"]), "nu": flat(o["nu"])},
            "where": where, "tally": CS.tally_counts(mesh.tally())}


@pytest.mark.parametrize("name,part,shape", [
    ("tinyllama", "tp", (1, 4)),
    ("tinyllama", "dp", (4, 1)),
    ("qwen2-moe", "moe", (4, 1)),
], ids=["tinyllama-1x4", "tinyllama-4x1", "qwen2-moe-4x1"])
def test_four_rank_step_matches_reference(name, part, shape):
    ref = _reference(name)
    arch, changes = CONFIGS[name]
    tcfg = pair(arch, changes)[2]
    want = CS.p15_predicted(T, tcfg, part, shape)
    for r, got in enumerate(run_mesh(shape, lambda mesh: _rank_step(name, mesh))):
        assert rel(got["loss"], ref["loss"]) <= 1e-5, (got["loss"], ref["loss"])
        assert rel(got["total"], ref["total"]) <= 1e-5
        for tree in ("params", "mu", "nu"):
            for k, idx in got["where"].items():
                err = rel(got["trees"][tree][k].numpy(), ref[tree][k][idx])
                assert err <= 1e-4, (r, tree, k, err)
        assert got["tally"] == want == _dry(tcfg, shape, r), (r, got["tally"], want)


@pytest.mark.parametrize("arch,changes,part,shape,dtype,extra", [
    ("tinyllama-1.1b", (), "tp", (1, 4), "float32", None),
    ("tinyllama-1.1b", (), "dp", (4, 1), "float32", None),
    ("tinyllama-1.1b", (), "2d", (2, 2), "float32", None),
    ("qwen2-moe-a2.7b", (("num_experts", 12),), "ep", (4, 1), "float32",
     {"moe_a2a": True}),
    ("llama2-13b", (), "tp", (1, 4), "bfloat16", None),
], ids=["tinyllama-1x4", "tinyllama-4x1", "tinyllama-2x2", "qwen2-moe-a2a-4x1",
        "llama2-13b-1x4-bf16"])
def test_predicted_collectives_equal_the_dry_run(arch, changes, part, shape, dtype,
                                                 extra):
    """``p15_predicted`` from the design, on every rank of part T's
    meshes (reduced configs), against the dry run's count."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    want = CS.p15_predicted(T, cfg, part, shape)
    for r in range(4):
        assert _dry(cfg, shape, r, dtype, extra) == want, r


class _Work:
    def __init__(self, log, t):
        self.log, self.t = log, t

    def wait(self):
        self.log.append("wait")
        self.t.mul_(2)             # two ranks' equal values, summed
        return True


class _NcclPG:
    """An NCCL group's stand-in: its all-reduce doubles the tensor when
    waited on, and records the order of the calls."""

    def __init__(self, log):
        self.log = log

    def name(self):
        return "nccl"

    def allreduce(self, tensors, opts):
        self.log.append("allreduce")
        return _Work(self.log, tensors[0])


class _Event:
    """``torch.cuda.Event``'s stand-in: 2.5 ms between a start and the
    end recorded after it."""

    def __init__(self, log, enable_timing=False):
        assert enable_timing
        self.log = log

    def record(self):
        self.log.append("record")

    def synchronize(self):
        self.log.append("synchronize")

    def elapsed_time(self, end):
        return 2.5


def test_nccl_collectives_timed_by_events(monkeypatch):
    """On NCCL an all-reduce is timed by two CUDA events around the call
    and its ``wait()`` (which only orders the stream), read when the
    seconds are, and only inside the window ``reset_tally(timing=True)``
    opens and the read closes: no host clock runs, no event outside the
    window or inside a graph capture."""
    log = []
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _Event(log, **kw))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)

    def no_clock():
        raise AssertionError("the host clock timed an NCCL collective")

    monkeypatch.setattr(M, "time", types.SimpleNamespace(perf_counter=no_clock))
    mesh = RankMesh(AXES, (1, 2), 0, "cpu", {"model": _NcclPG(log)})
    x = torch.ones(3)
    mesh.psum(x, "model")
    assert log == ["allreduce", "wait"] and mesh.seconds == {}     # not asked
    log.clear()
    mesh.reset_tally(timing=True)
    y = mesh.psum(x, "model")
    mesh.psum_(torch.ones(2), "model")
    assert torch.equal(y, torch.full((3,), 2.0)) and torch.equal(x, torch.ones(3))
    assert log == ["record", "allreduce", "wait", "record"] * 2
    assert mesh.kind_seconds == {("forward", "all-reduce"): 0.0025,
                                 ("update", "all-reduce"): 0.0025}
    assert mesh.seconds == {"forward": 0.0025, "update": 0.0025}
    assert log.count("synchronize") == 2
    log.clear()
    mesh.psum(x, "model")                   # the read closed the window
    assert log == ["allreduce", "wait"] and mesh._events == []
    mesh.reset_tally(timing=True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    log.clear()
    mesh.psum(x, "model")
    assert log == ["allreduce", "wait"] and mesh.seconds == {}
    assert mesh.tally()["forward"]["all-reduce"]["count"] == 1


def test_gloo_collectives_timed_by_host_clock():
    """On gloo (the CPU, or ranks sharing a card) each collective's host
    time is added to its phase and its (phase, kind), forward, backward
    and update, and ``reset_tally`` zeroes them."""
    def rank(mesh):
        x = torch.ones(4, requires_grad=True)
        with torch.enable_grad():
            y = mesh.all_gather(mesh.psum(x, "model", grad="psum"), "model", 0)
            y.sum().backward()
        mesh.psum_(torch.ones(2), "model")
        seconds, kinds = dict(mesh.seconds), dict(mesh.kind_seconds)
        mesh.reset_tally()
        return seconds, kinds, dict(mesh.seconds)

    for seconds, kinds, after in run_mesh((1, 2), rank):
        assert set(seconds) == {"forward", "backward", "update"}
        assert all(v > 0 for v in seconds.values())
        assert set(kinds) == {("forward", "all-reduce"), ("forward", "all-gather"),
                              ("backward", "all-reduce"), ("update", "all-reduce")}
        assert sum(kinds.values()) == pytest.approx(sum(seconds.values()))
        assert after == {}
