"""The port's dry run (``launch/dryrun.py``) on the meta device, its
meshes (``launch/mesh.py``) and the H100 cluster preset.

* ``RankMesh.dry``'s counted collectives (kind, count, bytes; forward,
  backward and update) equal a thread mesh's real counts for the same
  reduced case, train (with remat) and serving, for the decoders and the
  ssm, hybrid and audio families, and the meta inputs' bytes equal the
  real shards'.
* ``model_flops_analytic`` equals the reference's, key for key, for
  every arch x shape.
* ``main`` over one reduced arch writes records with the reference's
  keys where the quantity exists, ``memory_analysis`` among them, and
  names the ones that do not.
* ``MemoryTally``'s meta tally of a step's memory equals the same step's
  on real CPU tensors, and a hand-counted toy step gives its bytes.
* Nothing is allocated off the meta device."""
import dataclasses
import json
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.core.cluster import Cluster
from repro_torch.data import pipeline as TDP
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as LM
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import RankMesh
from repro_torch.training import optimizer as TOPT
from repro_torch.training import train as TTR
from _torch_mesh import AXES, run_mesh
from _torch_parity import one_torch_thread  # noqa: F401

#: name -> (arch, config changes, mesh, input shape, rules override)
CASES = {
    "dense-train-2x2": ("tinyllama-1.1b", (), (2, 2),
                        InputShape("t", "train", 16, 4), None),
    "moe-train-2x2": ("qwen2-moe-a2.7b", (("num_experts", 12),), (2, 2),
                      InputShape("t", "train", 16, 4), None),
    "moe-a2a-train-2x1": ("qwen2-moe-a2.7b", (("num_experts", 12),), (2, 1),
                          InputShape("t", "train", 16, 4),
                          {"moe_a2a": True}),
    "mla-train-1x2": ("minicpm3-4b", (), (1, 2),
                      InputShape("t", "train", 16, 2), None),
    "dense-prefill-2x2": ("tinyllama-1.1b", (), (2, 2),
                          InputShape("p", "prefill", 16, 4), None),
    "dense-decode-1x2": ("tinyllama-1.1b", (), (1, 2),
                         InputShape("d", "decode", 32, 2), None),
    "ssm-train-1x2": ("mamba2-780m", (), (1, 2),
                      InputShape("t", "train", 16, 2), None),
    "ssm-decode-1x2": ("mamba2-780m", (), (1, 2),
                       InputShape("d", "decode", 32, 2), None),
    "hybrid-train-1x2": ("zamba2-7b", (("num_layers", 3),), (1, 2),
                         InputShape("t", "train", 16, 2), None),
    "hybrid-prefill-2x2": ("zamba2-7b", (("num_layers", 3),), (2, 2),
                           InputShape("p", "prefill", 16, 4), None),
    "audio-train-1x2": ("whisper-medium", (), (1, 2),
                        InputShape("t", "train", 16, 2), None),
    "audio-prefill-1x2": ("whisper-medium", (), (1, 2),
                          InputShape("p", "prefill", 16, 2), None),
}
#: the keys of the reference's records (``repro.launch.dryrun.run_case``)
REFERENCE_KEYS = {"arch", "shape", "mesh", "tag", "status", "lower_s",
                  "compile_s", "memory_analysis", "cost_analysis",
                  "collectives", "hlo_ops", "analytic", "num_layers",
                  "per_device_arg_bytes", "n_devices"}


def _cfg(arch, changes):
    return dataclasses.replace(get_config(arch).reduced(), **dict(changes))


def _real_args(cfg, shape, rules, mesh):
    """The rank's real inputs, built apart from ``input_specs``: its
    shard of seeded fp32 weights, fresh fp32 moments, its rows of a
    batch (an audio config's frames too), its cache shard."""
    full = T.init_params(cfg, torch.Generator().manual_seed(0), "float32")
    params = SH.shard_params(full, SH.param_specs(cfg, full, rules, mesh),
                             mesh)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = next(TDP.sharded_batches(
            cfg, TDP.DataConfig(seq_len=S, global_batch=B), mesh,
            SH.batch_specs(rules)["tokens"], 1,
            frames=cfg.family == "audio"))
        if "frames" in batch:   # in the dry run's type, the reference's
            batch["frames"] = batch["frames"].to(torch.bfloat16)
        return (params, TOPT.init_opt_state(params, "float32"), batch)
    n = S if shape.kind == "prefill" else 1
    toks = SH.shard_leaf(torch.zeros((B, n), dtype=torch.int32),
                         (rules["batch"], None), mesh)
    cache = T.init_cache_shard(cfg, B, S, rules, mesh, "float32", "cpu")
    if shape.kind == "prefill" and cfg.family == "audio":
        frames = SH.shard_leaf(
            torch.zeros((B, cfg.encoder_seq_len, cfg.d_model),
                        dtype=torch.bfloat16), (rules["batch"], None), mesh)
        return (params, toks, cache, frames)
    if shape.kind == "prefill":
        return (params, toks, cache)
    return (params, toks, torch.full_like(toks, S // 2), cache)


@pytest.mark.parametrize("case", list(CASES))
def test_dry_counts_equal_real(case):
    arch, changes, shape_, ishape, override = CASES[case]
    cfg = _cfg(arch, changes)

    def run(mesh):
        kw = dict(dtype="float32", moments_dtype="float32",
                  rules_override=override, cfg_override=cfg)
        _, rules, step, meta = DR.input_specs(arch, ishape, mesh, **kw)
        real = _real_args(cfg, ishape, rules, mesh)
        _, real_tally, real_mem = DR.run_step(rules, step, real)
        dry = RankMesh.dry(AXES, shape_, mesh.rank)
        _, rules, step, dry_args = DR.input_specs(arch, ishape, dry, **kw)
        sizes = [DR.tree_bytes(a) for a in dry_args]
        assert sizes == [DR.tree_bytes(a) for a in real]
        # the train step's global shapes built afresh inside the dry step:
        # shape-only stand-ins are neither its memory nor its work
        TTR._global_params.cache_clear()
        _, dry_tally, dry_mem = DR.run_step(rules, step, dry_args)
        return real_tally, dry_tally, real_mem, dry_mem

    for real, dry, real_mem, dry_mem in run_mesh(shape_, run):
        assert real == dry
        # the meta tally of the step's memory is the real tensors' one;
        # gloo's worker thread drops its hold on a collective's operand
        # after the wait returns, so on a loaded host a real run may see
        # that buffer die an op late: temp within 1%, the rest exact
        temp, want = real_mem.pop("temp_size_in_bytes"), dry_mem.pop(
            "temp_size_in_bytes")
        assert real_mem == dry_mem
        assert want > 0 and abs(temp - want) <= 0.01 * want
        if ishape.kind == "train":
            assert real["backward"] and real["forward"]


def test_model_flops_analytic_matches_reference():
    """Every arch x input shape, key for key. The reference's module
    sets ``XLA_FLAGS`` on import; it is restored before any JAX
    computation runs."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.configs import get_config as jax_config
        from repro.configs import INPUT_SHAPES as JSHAPES
        from repro.launch import dryrun as JDR
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    for arch in DR.ASSIGNED_ARCHS + ["llama2-13b", "llama2-70b"]:
        for name, shape in INPUT_SHAPES.items():
            got = DR.model_flops_analytic(get_config(arch), shape)
            want = JDR.model_flops_analytic(jax_config(arch), JSHAPES[name])
            assert got == want, (arch, name)


def test_main_writes_reference_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(DR, "get_config", lambda a: get_config(a).reduced())
    assert DR.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                    "--out", str(tmp_path)]) == 0
    assert DR.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                    "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "tinyllama-1.1b__train_4k__16x16.json")
                     .read_text())
    assert rec["status"] == "ok"
    missing = {"hlo_ops", "lower_s", "compile_s"}
    assert REFERENCE_KEYS - missing <= set(rec)
    assert not missing & set(rec)
    for k in missing:
        assert any(k in name for name in rec["unavailable"])
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes"}
    assert mem["argument_size_in_bytes"] == rec["per_device_arg_bytes"]
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert [k for k in rec["unavailable"] if k.startswith("memory")] == [
        "memory_analysis.generated_code_size_in_bytes"]
    assert rec["n_devices"] == 256 and rec["num_layers"] == 2
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["per_device_arg_bytes"] == sum(
        rec["per_device_arg_bytes_by_input"].values())
    for kind, v in rec["collectives"].items():
        assert set(v) == {"count", "bytes"} and v["count"] > 0, kind
    ssm = json.loads((tmp_path / "mamba2-780m__decode_32k__16x16.json")
                     .read_text())
    assert ssm["status"] == "ok" and ssm["collectives"]["all-reduce"][
        "count"] == 1 + 2 * ssm["num_layers"]
    assert "[dryrun] tinyllama-1.1b__train_4k__16x16: ok" in \
        capsys.readouterr().out


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_memory_tally_of_a_toy_step(device):
    """A hand-counted step: a new buffer counts its bytes, a view and an
    in-place op none, a buffer counts until its last view dies, and one
    autograd saves lives on while its graph does."""
    x = torch.zeros(256, device=device)              # the argument, 1 KiB
    a = torch.ones(256, device=device, requires_grad=True)
    mem = DR.MemoryTally((x, a))
    assert mem.base == 2048
    with mem:
        y = x * 2                                    # +1024
        v = y.view(16, 16)                           # a view: +0
        z = v + 1                                    # +1024: the peak
        del y
        z.add_(1)                                    # y lives on in v
        assert mem.bytes - mem.base == 2048
        del v
        z.add_(1)                                    # y is gone
        assert mem.bytes - mem.base == 1024
        e = a.exp()                                  # +1024, saved
        s = e.sum()                                  # +4
        del e
        s.add(0)                                     # +4; e held by s
        assert mem.bytes - mem.base == 1024 + 1024 + 4 + 4
        del s
        out = z.sum()                                # all but z gone; +4
        assert mem.bytes - mem.base == 1024 + 4
    assert DR.memory_analysis(DR.tree_bytes((x, a)), out, mem) == {
        "argument_size_in_bytes": 2048, "output_size_in_bytes": 4,
        "temp_size_in_bytes": 1024 + 1024 + 4 + 4}


class _Devices(TorchDispatchMode):
    """Records the device of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.add((t.device.type, str(func)))
        return out


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "long_500k"])
def test_nothing_allocated_off_meta(shape):
    """The inputs, the step and its counting, on the production mesh
    (reduced moe, so routing and the experts' all-to-all run too)."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              num_experts=12)
    mesh = RankMesh.dry(*LM.PRODUCTION_SHAPE[False][::-1])
    with _Devices() as rec:
        _, rules, step, args = DR.input_specs(
            cfg.name, shape, mesh, cfg_override=cfg,
            rules_override={"moe_a2a": True})
        DR.run_step(rules, step, args)
    off = {f for dev, f in rec.seen if dev != "meta"}
    assert not off, sorted(off)[:5]


def test_launch_meshes(monkeypatch):
    """``make_host_mesh``: n ranks on the first axis (threads over one
    store), its collective working; ``make_production_mesh``: the
    reference's shapes and axes, built only when called."""
    import torch.distributed as dist

    store = dist.HashStore()

    def rank(r):
        m = LM.make_host_mesh(store, r, "cpu", n=2, axes=("data", "model"))
        return m.shape, m.psum(torch.ones(2), "data").tolist()

    import threading
    out = [None, None]
    ts = [threading.Thread(target=lambda r=r: out.__setitem__(r, rank(r)))
          for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert out == [((2, 1), [2.0, 2.0])] * 2

    calls = []
    monkeypatch.setattr(LM.RankMesh, "build",
                        classmethod(lambda cls, *a: calls.append(a)))
    LM.make_production_mesh("store", 5, "cuda")
    LM.make_production_mesh("store", 7, "cuda", multi_pod=True)
    assert calls == [("store", ("data", "model"), (16, 16), 5, "cuda"),
                     ("store", ("pod", "data", "model"), (2, 16, 16), 7,
                      "cuda")]


def test_h100_cluster():
    """``Cluster.h100``, the counterpart of the reference's ``tpu_v5e``:
    the H100 SXM data sheet's HBM, dense bf16 rate and NVLink rate."""
    from repro.core.cluster import Cluster as JCluster

    c, ref = Cluster.h100(4), JCluster.tpu_v5e(4)
    assert len(c.devices) == len(ref.devices) == 4
    assert [d.device_id for d in c.devices] == [0, 1, 2, 3]
    assert {(d.mem_capacity, d.compute_flops) for d in c.devices} == \
        {(80e9, 989e12)}
    assert c.link_bandwidth == 450e9
    assert len(c.eligible_nodes()) == 4
