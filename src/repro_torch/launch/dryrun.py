"""Dry run on the meta device: one rank's step of every (arch x input
shape) on the production meshes, with NO allocation.

The port's counterpart of ``repro.launch.dryrun``. Where the reference
lowers and compiles the whole sharded program over ``ShapeDtypeStruct``
stand-ins, this runs rank 0's part of it on meta tensors: its shards of
the params and the optimizer state (bf16 moments), its rows of the batch
or its shard of the cache (``input_specs``), over ``RankMesh.dry``, whose
collectives count their kind and bytes, forward and backward, and return
meta tensors of the right shape. A train case runs the whole step
(forward, backward, the gradient sums and the update, under remat as
the reference's); a serving case one prefill or decode call.

Per case it records, with the reference's keys where the quantity
exists: ``analytic`` (``model_flops_analytic``, the reference's
function), ``per_device_arg_bytes`` (and its parts by input),
``n_devices``, ``num_layers``, ``collectives`` (``{kind: {count,
bytes}}``, counted as they run, also by phase), ``cost_analysis.flops``
(``torch.utils.flop_counter.FlopCounterMode`` over the rank's step),
``memory_analysis`` and ``status``.

``memory_analysis`` holds the reference's ``argument_size_in_bytes``,
``output_size_in_bytes`` and ``temp_size_in_bytes`` of the rank's step,
from ``MemoryTally``, a dispatch mode nested with the FLOP counter: it
tallies the live bytes of the storages the step's ops create (a storage
once across its views, freed when it dies) and keeps their peak. The
arguments are the inputs' bytes (``tree_bytes``), the output the step's
outputs', and temp the peak live bytes beyond the arguments: the eager
counterpart of XLA's buffer assignment, where a buffer lives from the op
that makes it to the death of its last tensor (an op's internal
scratch only where ``MemoryTally.SCRATCH`` names the op). Arguments +
temp predicts the step's peak on a card. XLA's generated-code size and
the HLO-derived fields have no torch counterpart: ``unavailable`` names
them, and nothing stands in for them. A case whose step raises
``NotImplementedError`` records ``"not_ported"`` with the reason.
Records land in ``dryrun_artifacts/`` as JSON.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch tinyllama-1.1b --shape train_4k

Skips (the reference's): whisper-medium x long_500k (bounded enc-dec
decoder).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, InputShape,
                                 get_config)
from repro_torch.launch.mesh import PRODUCTION_SHAPE
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.mesh import RankMesh
from repro_torch.training import optimizer as OPT
from repro_torch.training import train as TR

#: what the reference's records hold that a torch run cannot measure
UNAVAILABLE = {
    "memory_analysis.generated_code_size_in_bytes": "XLA's compiled code "
                                                    "(a torch step runs "
                                                    "eager kernels)",
    "hlo_ops": "the partitioned HLO's line count",
    "lower_s / compile_s": "XLA's lowering and compilation (run_s is the "
                           "meta step's wall time)",
    "cost_analysis.bytes_accessed / transcendentals": "XLA's cost model "
                                                      "(FlopCounterMode "
                                                      "counts FLOPs only)",
    "collectives.bytes_scaled": "scan-trip scaling of HLO counts (the port "
                                "counts every collective as it runs)",
}

#: the names of a step's inputs, by shape kind
INPUT_NAMES = {"train": ("params", "opt_state", "batch"),
               "prefill": ("params", "tokens", "cache", "frames"),
               "decode": ("params", "tokens", "positions", "cache")}


def model_flops_analytic(cfg, shape) -> dict:
    """Architecture-exact step FLOPs (global, fwd; train multiplies by 3).

    MODEL_FLOPS uses the 6·N_active·D convention (2·N fwd + 4·N bwd per
    token); attention-score FLOPs are reported separately.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        mult = 3.0  # fwd + bwd
        ctx = S / 2
    elif shape.kind == "prefill":
        tokens = B * S
        mult = 1.0
        ctx = S / 2
    else:  # decode: ONE token per request
        tokens = B * 1
        mult = 1.0
        ctx = S
        if cfg.sliding_window and cfg.family in ("dense", "moe", "vlm") \
                and S > cfg.sliding_window:
            ctx = cfg.sliding_window
    n_total = cfg.param_count()
    n_active = n_total
    if cfg.num_experts:
        expert = 3 * cfg.d_model * cfg.d_ff
        routed_all = cfg.num_experts * expert * cfg.num_layers
        active_routed = cfg.num_experts_per_tok * expert * cfg.num_layers
        n_active = n_total - routed_all + active_routed
    linear = 2.0 * n_active * tokens
    attn_scores = 0.0
    if cfg.attention_kind != "none":
        hd = cfg.resolved_head_dim if cfg.attention_kind == "gqa" else \
            (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        n_attn_layers = (cfg.num_layers if cfg.hybrid_attn_every == 0
                         else cfg.num_layers // cfg.hybrid_attn_every)
        attn_scores = (4.0 * tokens * ctx * cfg.num_heads * hd
                       * n_attn_layers)
    ssd = 0.0
    if cfg.ssm_state:
        # state update + output contraction per token per head
        ssd = (6.0 * tokens * cfg.ssm_heads * cfg.ssm_head_dim
               * cfg.ssm_state * cfg.num_layers)
    total = (linear + attn_scores + ssd) * mult
    return {"model_flops_global": total,
            "model_flops_6nd": 6.0 * n_active * tokens if shape.kind == "train"
            else 2.0 * n_active * tokens,
            "n_active": n_active, "tokens": tokens}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name, mesh, *, dtype="bfloat16",
                moments_dtype="bfloat16", rules_override=None,
                cfg_override=None, remat: bool = True):
    """(cfg, rules, step, args): the rank's meta stand-ins (no
    allocation) for every input of (arch, shape) on ``mesh`` (a
    ``RankMesh``, dry or real: only its geometry is read), and the step
    that takes them. ``shape_name`` is a key of ``INPUT_SHAPES`` or an
    ``InputShape``. Train: params and optimizer state (``moments_dtype``
    moments) sharded by ``param_specs`` / ``opt_state_specs``, the batch
    by ``batch_specs``; serving: params, tokens (and positions) and the
    cache's shard (``init_cache_shard``)."""
    cfg = cfg_override or get_config(arch)
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    B, S = shape.global_batch, shape.seq_len
    long_ctx = shape.name == "long_500k"
    rules = (SH.long_context_rules(cfg, mesh) if long_ctx
             else SH.rules_for(cfg, mesh))
    if rules_override:
        rules.update(rules_override)
    rules["mesh"] = mesh  # needed by distributed ops (flash_decode, MoE a2a)
    bspec = rules.get("batch")

    def shard(tree, specs):
        return SH.shard_params(tree, specs, mesh)

    full = T.init_params_meta(cfg, dtype)
    params = shard(full, SH.param_specs(cfg, full, rules, mesh))

    if shape.kind == "train":
        opt = OPT.init_opt_state(params, moments_dtype=moments_dtype)
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32),
                 "mask": _meta((B, S), torch.float32)}
        if cfg.family == "audio":
            batch["frames"] = _meta((B, cfg.encoder_seq_len, cfg.d_model),
                                    torch.bfloat16)
        batch = shard(batch, SH.batch_specs(rules, cfg.family == "audio"))
        step = TR.make_train_step(cfg, OPT.OptimizerConfig(),
                                  dispatch="auto", remat=remat)
        return cfg, rules, step, (params, opt, batch)

    # serving shapes ------------------------------------------------------
    window = None
    M = S
    if shape.kind == "decode" and long_ctx \
            and cfg.family in ("dense", "moe", "vlm"):
        window = M = cfg.sliding_window
    cache = T.init_cache_shard(cfg, B, M, rules, mesh, dtype, device="meta")

    if shape.kind == "prefill":
        tokens = SH.shard_leaf(_meta((B, S), torch.int32), (bspec, None),
                               mesh)
        frames = None
        if cfg.family == "audio":
            frames = SH.shard_leaf(
                _meta((B, cfg.encoder_seq_len, cfg.d_model), torch.bfloat16),
                (bspec, None, None), mesh)

        def step(params, tokens, cache, frames=None):
            logits, new_cache, _ = T.forward(
                params, cfg, tokens, mode="prefill", cache=cache,
                encoder_input=frames, dispatch="auto")
            return logits, new_cache

        args = (params, tokens, cache) + ((frames,) if frames is not None
                                          else ())
        return cfg, rules, step, args

    # decode: ONE new token against a seq_len-deep cache
    tokens = SH.shard_leaf(_meta((B, 1), torch.int32), (bspec, None), mesh)
    positions = SH.shard_leaf(_meta((B, 1), torch.int32), (bspec, None),
                              mesh)

    def step(params, tokens, positions, cache):
        logits, new_cache, _ = T.forward(
            params, cfg, tokens, positions=positions, mode="decode",
            cache=cache, window=window, dispatch="auto")
        return logits, new_cache

    return cfg, rules, step, (params, tokens, positions, cache)


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a nested dict / tuple / tensor."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class MemoryTally(TorchDispatchMode):
    """The live bytes of a step's storages and their peak beyond its
    arguments (the step's ``temp_size_in_bytes``).

    The arguments' storages are live from the start (``base`` bytes). A
    storage an op returns is counted once, whatever its views; an
    in-place op or a view of one counted already adds nothing. Each
    tensor counted carries a weak-reference finaliser; when the last of
    a storage's tensors dies, the storage is checked at the next op and
    uncounted once it is gone (a tensor that autograd saves keeps it
    alive; an argument the step replaces, as an update replaces bf16
    moments by fp32 ones, is freed). The peak is read after each op's
    outputs are counted, the frees before it already taken: the live
    bytes when the op's outputs are allocated. Only tensors on the
    arguments' device count (a real step's meta stand-ins hold no
    memory); on the meta device the tally is the real device's.

    An op's kernel may hold scratch of its own while it runs, which no
    dispatch mode sees: ``SCRATCH`` gives it, as a multiple of the op's
    output bytes, for the ops where the card's kernels were seen to
    (``chip_memory_probe.py``); it raises the peak at that op only."""

    #: op -> scratch bytes a kernel holds while it runs, per output byte:
    #: the CUDA softmax backward holds two buffers of its output's size
    #: (measured on an H100 for every softmax backward of the attention)
    SCRATCH = {"aten._softmax_backward_data.default": 2}

    def __init__(self, args=()):
        super().__init__()
        leaves = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
        self.device = leaves[0].device if leaves else None
        self.live = {}        # key -> [weak ref, bytes, tensors seen alive]
        self.maybe_dead = set()
        self.bytes = 0
        for t in leaves:
            self._count(t)
        self.base = self.peak = self.bytes

    def _count(self, t):
        st = t.untyped_storage()
        key = st._cdata
        entry = self.live.get(key)
        if entry is not None and entry[0].expired():      # address reused
            self.bytes -= entry[1]
            self.maybe_dead.discard(key)
            entry = None
        if entry is None:
            entry = self.live[key] = [StorageWeakRef(st), st.nbytes(), 0]
            self.bytes += entry[1]
        entry[2] += 1
        weakref.finalize(t, self._dropped, key, entry[0])

    def _sweep(self):
        for key in list(self.maybe_dead):
            ref, n, alive = self.live[key]
            if alive == 0 and ref.expired():
                del self.live[key]
                self.bytes -= n
            if alive or ref.expired():
                self.maybe_dead.discard(key)

    def _dropped(self, key, ref):
        entry = self.live.get(key)
        if entry is not None and entry[0] is ref:
            entry[2] -= 1
            if entry[2] == 0:
                self.maybe_dead.add(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._sweep()
        out = func(*args, **(kwargs or {}))
        out_bytes = 0
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device == self.device:
                self._count(t)
                out_bytes += t.untyped_storage().nbytes()
        self.peak = max(self.peak,
                        self.bytes + self.SCRATCH.get(str(func), 0) * out_bytes)
        return out

    @property
    def temp(self) -> int:
        return self.peak - self.base


def memory_analysis(arg_bytes: int, out, tally: MemoryTally) -> dict:
    """The reference's ``memory_analysis`` keys of one step: its inputs'
    bytes (``tree_bytes`` before the step), its outputs' and the peak of
    what it allocated beyond its arguments."""
    out_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
    return {"argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(tally.temp)}


def run_step(rules, step, args):
    """(flops, tally, memory): ``step(*args)`` run under ``rules`` and
    counted: the FLOPs ``FlopCounterMode`` sees, the mesh's collectives
    by phase (``RankMesh.tally``) and ``memory_analysis`` from a
    ``MemoryTally`` nested inside the FLOP counter."""
    mesh = rules["mesh"]
    mesh.reset_tally()
    arg_bytes = tree_bytes(args)
    mem = MemoryTally(args)
    with SH.use_rules(rules), FlopCounterMode(display=False) as fc, mem:
        out = step(*args)
    return fc.get_total_flops(), mesh.tally(), memory_analysis(arg_bytes,
                                                               out, mem)


def collectives_of(tally) -> dict:
    """``{kind: {count, bytes}}`` over every phase of a tally."""
    out = {}
    for by_kind in tally.values():
        for kind, v in by_kind.items():
            e = out.setdefault(kind, {"count": 0, "bytes": 0})
            e["count"] += v["count"]
            e["bytes"] += v["bytes"]
    return out


def should_skip(arch: str, shape_name: str):
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.supports_long_decode:
        return f"{arch} is encoder-decoder with a bounded decoder; long_500k skipped (DESIGN.md §4)"
    return None


def run_case(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             rules_override=None, cfg_override=None, tag: str = "") -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    case = f"{arch}__{shape_name}__{mesh_name}{tag}"
    skip = should_skip(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag}
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return _finish(rec, out_dir, case)
    try:
        shape, axes = PRODUCTION_SHAPE[multi_pod]
        mesh = RankMesh.dry(axes, shape)
        t0 = time.time()
        cfg, rules, step, args = input_specs(
            arch, shape_name, mesh, rules_override=rules_override,
            cfg_override=cfg_override)
        # the inputs' bytes before the step: an update replaces bf16
        # moments by fp32 ones, as the reference's does
        kind = INPUT_SHAPES[shape_name].kind
        parts = dict(zip(INPUT_NAMES[kind], (tree_bytes(a) for a in args)))
        flops, tally, memory = run_step(rules, step, args)
        rec["run_s"] = round(time.time() - t0, 1)
        rec["cost_analysis"] = {"flops": float(flops)}
        rec["collectives"] = collectives_of(tally)
        rec["collectives_by_phase"] = tally
        rec["memory_analysis"] = memory
        rec["analytic"] = model_flops_analytic(cfg, INPUT_SHAPES[shape_name])
        rec["num_layers"] = cfg.num_layers
        # per-device input footprint from the shards (proves it fits)
        rec["per_device_arg_bytes"] = int(sum(parts.values()))
        rec["per_device_arg_bytes_by_input"] = parts
        rec["n_devices"] = int(mesh.size)
        rec["unavailable"] = UNAVAILABLE
        rec["status"] = "ok"
    except NotImplementedError as e:
        rec["status"] = "not_ported"
        rec["reason"] = str(e)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return _finish(rec, out_dir, case)


def _finish(rec, out_dir, case):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, case + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = rec.get("status")
    extra = ""
    if status == "ok":
        ca = rec.get("cost_analysis", {})
        extra = (f" flops={ca.get('flops', 0):.3g}"
                 f" argGB/dev={rec['per_device_arg_bytes']/2**30:.2f}"
                 f" run={rec.get('run_s')}s")
    elif status in ("error", "not_ported"):
        extra = " " + rec.get("error", rec.get("reason", ""))[:160]
    print(f"[dryrun] {case}: {status}{extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_artifacts")
    # beyond-paper optimization toggles (the reference's)
    ap.add_argument("--tp-pad", action="store_true",
                    help="head padding / KV replication for TP alignment")
    ap.add_argument("--moe-a2a", action="store_true",
                    help="expert-parallel all-to-all MoE dispatch")
    ap.add_argument("--flash-decode", action="store_true",
                    help="distributed flash-decoding for seq-sharded caches")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    rules_override = {}
    tag = ""
    if args.moe_a2a:
        rules_override["moe_a2a"] = True
        tag += "+moe_a2a"
    if args.flash_decode:
        rules_override["flash_decode"] = True
        tag += "+flashdecode"
    n_err = 0
    for arch in archs:
        for shape in shapes:
            cfg_override = get_config(arch).tp_padded(16) if args.tp_pad \
                else None
            for mp in meshes:
                rec = run_case(arch, shape, multi_pod=mp, out_dir=args.out,
                               rules_override=rules_override or None,
                               cfg_override=cfg_override,
                               tag=tag + ("+tppad" if args.tp_pad else ""))
                n_err += rec["status"] == "error"
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
