"""The port across four cards of one host over NCCL (card only: four
H100s joined by NVLink).

    python3 chip_multicard.py [--parts K,M1,M2,M3,M4,T,S,E]

``chip_smoke.py`` stays the one-card script; this one runs the paths
that exist only across cards, one rank process per card
(``torch.cuda.set_device(rank)``), over a ``TCPStore`` on localhost. Every
group is NCCL (``parallel.mesh.backend_for``: a card per rank). It
raises unless four cards are visible, fails when any rank fails, and
exits 0 only when every gate of every part it ran holds. It prints each
card's ``nvidia-smi`` name and power limit and ``nvidia-smi topo -m``.
``--cpu`` rehearses the same rank code on four CPU processes over gloo
at reduced sizes, without the card-only gates (graphs, kernels, times).

K. The paged-decode kernel at this slice's new shapes, on every card:
   llama2-13b's replicated rows (B 4 at degree 2, B 2 at degree 4; H =
   KV = 40, D 128) and llama2-70b's rank (B 8, H 16, KV 2, D 128), held
   against ``paged_decode_attention_ref`` (fp32 3e-5, bf16 2e-2), and
   timed on card 0 beside its bound and its plain version.
M1. Groups: ``RankMesh.build`` on (1, 4) and (2, 2), ``make_host_mesh``
   and ``ReplicationGroup.build`` give NCCL groups on every axis line, rank
   r on ``cuda:r``; all-reduce (sum, max), the mesh's all-gather, the
   replication hooks' gather and an uneven uint8 ``alltoall_base`` equal a
   host computation. Printed: a 128 KB all-reduce eager and replayed in a
   CUDA graph, a 1 GiB all-reduce's bus bandwidth.
M2. llama2-13b at published width and depth replicated across 2 and 4
   cards: rank 0 draws it (26.0 GB of bf16), ``replicate_params_for_plan``
   broadcasts it; each rank serves phase 5's workload through an
   ``Engine(group=...)`` on its card, in graphs and eagerly: all ones,
   ``[2]*20 + [1]*20`` on two pairs of ranks and on all four, ``[4]*40``
   on four, and a plan changed mid-serve. Gates: a replicated plan's decode
   steps replay from graphs (no eager decode step, one capture per decode
   key), one host sync per replayed steady step (sync-debug "error"),
   all-gathers per step as ``predicted_gathers``, every rank's tokens
   equal at every step and pools bit-equal, graph streams equal to eager
   ones, and each replicated plan's eager greedy streams equal to degree
   1's but where a top-2 tie within ``BF16_TIE`` flips (phase 12's rule at
   the bf16 tolerance); every paged call of one steady replicated step
   against its plain version (2e-2). Printed: step ms per plan, graphs and
   eager, against the 7.673 ms weight-read bound.
M3. llama2-13b's modules re-placed card to card (``migrate_by_path`` /
   ``migrate_kv_cache``, one all-to-all a leaf), at full depth with a bf16
   KV cache of 8 x 1024, ranks 1-3 on ``meta`` placeholders: phase 12's
   re-placement moves of ``chip_smoke.py`` at W = 4 (``MOVES``). Gates:
   each rank's bytes received equal the plan's and the move's share,
   every re-placed leaf bit-equal to rank 0's
   original slice, each non-owner's peak over (a) grown by its shards and
   at most ``CS.REPLACE_SLACK`` more, one paged decode step on the re-placed
   weights bit-equal on every rank to rank 0's unmoved step (``L``
   paged launches a rank). Printed: the group's first all-to-all (NCCL's
   point-to-point set-up, timed apart), GB/s per move, ``estimate_cost``
   beside the measured seconds, the constants fitted to the moves.
M4. llama2-70b tensor-parallel on (data 1, model 4) at published width and
   depth: each rank's 34.49 GB of bf16 shards from the sharded draw
   (``transformer.init_params_shard``; peak gated to the shard + one fp32
   chunk), its pool at 2 KV heads (8 x 1024); phase 5's prompts prefilled
   under rules, then ``M4_STEPS`` greedy decode steps of ``forward_paged``
   under rules, eagerly and as one CUDA graph per rank. Gates: replayed
   logits bit-equal to the eager step's, the two streams equal, 161
   all-reduces and 1 all-gather a step (on ``RankMesh.collectives``), 80
   paged launches a step, one host sync per replayed step; the fp32 cut
   (``M4_CUT`` of 80 layers, TF32 off) sharded against the unsharded step
   on card 0, logits within 1e-4. Printed: step ms eager and graph against
   the per-rank weight-read bound, device busy and the NCCL kernels'
   share of a replayed step (profiled on rank 0).
T. The sharded train step (``training.train`` under sharding rules), one
   rank process a card over NCCL, phase 15's machinery (``CS.p15_part``)
   with each rank's unsharded twin on its own card at the same time;
   fp32, TF32 off, phase 14's batch of 8 x 128 (``sharded_batches``), 3
   steps. T1 tinyllama-1.1b at published width and depth (22 layers) on
   (data 1, model 4), (4, 1) and (2, 2) (a rank in two groups, one an
   axis line), each also in bf16 for ``TRAIN_STEPS`` on one repeated
   batch; T2 qwen2-moe-a2.7b at published width (60 experts, padded to
   64: 16 a rank on ``data``) at ``T2_LAYERS`` of 24 on (4, 1), the
   scatter dispatch (gated as 15c: expert ids equal at step 1, losses and
   shards after it) and the all-to-all dispatch (``rules["moe_a2a"]``, as
   15c-a2a); T3 llama2-13b on (1, 4): an fp32 cut of ``T3_CUT`` layers
   against its twin, and at published depth (40 layers) bf16 shards from
   the sharded draw with fp32 moments, ``TRAIN_STEPS`` on one repeated
   batch. Gates, every rank: collectives by phase and kind a step =
   ``CS.p15_predicted`` = the dry run's (``RankMesh.dry``); params +
   moments bytes = the dry run's; losses within 1e-5 and shards of the
   params and both moments within 1e-4 of the twin (T1's after step 1;
   T1 runs phase 15e's witness over all three steps: each step sharded
   against unsharded in float64 within ``CS.F64_TOL``, the float32 shards
   after each step beside the ulp control, ungated); bf16 losses fall by
   more than ``TRAIN_FALL``; T3's full-depth peak within ``T3_MEMORY_TOL``
   of the dry run's ``memory_analysis`` (arguments + temp); the four
   kernels' launch counters unchanged; no step more host syncs (sync-debug
   "warn", one warning a sync) than its twin's, after one backward through
   an NCCL all-reduce has warmed the process. Printed: step ms beside
   14a's, collective ms by phase (CUDA events around each NCCL
   all-reduce), the logits' all-gather, each group's warm-up, each rank's
   peak, the NCCL kernels' share of one profiled step (rank 0).
S. The live serving loop over instances that span the four cards
   (``serving.group.GroupInstance``: an engine-server process a card in
   one NCCL replication group, the reference's mesh of every device),
   llama2-13b at published width and depth in bf16. Part S runs in this
   process, after the rank parts, with two instances of four ranks: eight
   servers, two a card. S1: ``launch.serve.run(ServeConfig(arch=
   "llama2-13b", reduced=False, instances=2, requests=24, rps=4,
   drain=True))`` as a user runs it; gates: 24 finished, ``dropped=0``,
   every server exits 0. S2: the paper's §5 loop as
   ``benchmarks/module_scaling_bench.py`` runs it: steady traffic, a burst
   pinned to instance 0, the controller's scale-up (or, if the card's
   telemetry does not trip ``t_up``, a vacancy snapshot fed to it, said
   so), ``[4]*40`` through the handles, instance 0 drained onto 1
   stop-the-world and 1 onto 0 two-phase with 3 overlap steps; every
   server checks its imports against their payloads and its steady steps
   under sync-debug "error", and runs its first steady replicated step
   eagerly with every paged call held against its plain version. Gates,
   every rank: a plan reaches every rank of an instance at the same step
   and every rank's tokens agree at every step (the handle raises
   otherwise); decode steps replay from graphs (no eager decode step but
   the checked one, one capture per key); one host sync per replayed
   steady step; all-gathers per replicated step = ``CS.predicted_gathers``;
   pools bit-equal after every plan and move; every import read back
   bit-equal on every rank of the destination; ``dropped`` 0; paged
   launches = layers x decode steps; the checked step's paged calls within
   2e-2; the streams equal one unreplicated card's run of the same
   requests but where both tokens are a tie within ``BF16_TIE`` of the top
   logit (read by a cache-less forward over the common prefix on that
   card). Printed beside the cards' name and power limit: step ms per
   plan against the 7.673 ms weight-read bound, TTFT and tok/s before,
   during and after the burst, the scale-up's latency (decision to the end
   of the first step under the new plan, captures included), bytes and
   ms per moved request beside ``estimate_cost``, each server's bring-up
   (spawn, group, draw, broadcast) and each card's peak memory.
   ``--cpu`` rehearses S on eight CPU server processes over gloo at the
   reduced config (``OMP_NUM_THREADS=1``), without the card-only gates.
E. The other serving planes over such instances (llama2-13b at published
   width, bf16, instances of four cards), each brought up by
   ``launch.serve.build_plane`` and driven by ``serve_workload`` /
   ``serve_http``, in this process after S. E1: ``--workers 2
   --supervise --drain``, 24 requests at rps 4, ``[4]*40`` from step
   ``E1_PLAN_AT``; rank 2 of w1 is SIGKILLed right after a step went out
   to its ranks (the others wait in the step's collectives); gates: w1
   fails within 5 s of the kill with no RPC deadline, its streams replay
   on w0, ``w1~r1`` comes back on cards 0-3 with every rank's weights
   equal to w0's, card memory after the respawn at most S2's (or, run
   alone, the figure before the kill) plus ``E_MEMORY_SLACK``, a request
   pinned to w1~r1 finishes there with one checked replicated step (every
   paged call within 2e-2 of its plain version), 25 finished, dropped 0,
   paged launches = layers x decode steps, every server exits 0; printed:
   the detection time, the downtime, the loop's stall in the step that
   brought w1~r1 up, the replayed greedy streams against one undisturbed
   card with each flip's top-2 gap. E2: ``--http --elastic --max-pod 2``
   from one instance; a client posts ``E2_REQUESTS`` completions,
   ``E2_CLIENTS`` at once, to the ingress and ends the serve with a
   Ctrl-C once the pod shrank; the grouped factory's fresh group runs one
   checked replicated step of a probe request before the pod admits it;
   gates: the pod log holds one grow and one shrink, every completion 200
   with its tokens, none dropped, every server (the retired group's
   within the 60 s its close allows) exits 0, card memory after the
   shrink within ``E_MEMORY_SLACK`` of one instance's; printed: the
   grow's wall time and the new communicator's first collective. E3:
   ``--inventory`` of one spawn node on 127.0.0.1 of capacity 2: two
   instances of four consecutive endpoints, 12 requests with a drain,
   dropped 0, every server exits 0. ``--cpu --parts E`` rehearses E on
   CPU server processes over gloo at the reduced config.

"""
from __future__ import annotations

import argparse
import ast
import collections
import contextlib
import dataclasses
import datetime
import functools
import gc
import json
import os
import queue
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import chip_smoke as CS  # noqa: E402

ROOT = Path(__file__).resolve().parent
WORLD = 4
AXES = ("data", "model")
TIMEOUT = datetime.timedelta(seconds=600)
#: M2's greedy flips: a replicated plan's stream may leave degree 1's only
#: where both runs' top-2 logits lie within this share of the top one
#: (phase 12's 1e-4 rule, at the bf16 logits' tolerance)
BF16_TIE = 2e-2
#: M4's greedy decode steps, and the fp32 cut's depth and steps
M4_STEPS, M4_CUT, CUT_STEPS = 32, 8, 4
#: T2's qwen2-moe-a2.7b depth (of 24): its unsharded fp32 twin must fit
#: one card (~9.1 GB of params, gradients and moments a layer, ~10 GB for
#: the embedding and lm_head)
T2_LAYERS = 4
#: T3's fp32 cut of llama2-13b (of 40 layers), held against the unsharded
#: fp32 step on each rank's card
T3_CUT = 4
#: T3's full-depth peak a rank against the dry run's memory_analysis
T3_MEMORY_TOL = 0.05
#: phase 14a's unsharded tinyllama-1.1b step on one card (PERF.md §5)
STEP14 = "14a's unsharded tinyllama-1.1b step on one card: bf16 248-257 ms, fp32 247.1 ms"
#: M3's moves at W = 4: (step, tree, path regex, placement, the share of
#: the moved leaves' bytes rank 0 and each other rank receive). (a) the
#: attention projections split over r0 and r1 on their heads (wo on its
#: rows), (b) back replicated, (c) every other leaf replicated, w_up /
#: w_down split on d_ff (each rank holds its quarter already) and
#: replicated again, (d) the KV cache split on its KV heads and back
R01 = ("r0", "r1")
MOVES = (
    ("a", "params", r"layers/attn/w[qkv]$", (None, None, R01), (0, 0.25)),
    ("a", "params", r"layers/attn/wo$", (None, R01), (0, 0.25)),
    ("b", "params", r"layers/attn/", (), (0.75, 0.75)),
    ("c", "params", r"^(?!layers/attn/)", (), (0, 1)),
    ("c split", "params", r"layers/mlp/w_up$", (None, None, R01), (0, 0)),
    ("c split", "params", r"layers/mlp/w_down$", (None, R01), (0, 0)),
    ("c back", "params", r"layers/mlp/w_(up|down)$", (), (0.75, 0.75)),
    ("d", "cache", r"layers/", (None, None, None, R01), (0, 0.25)),
    ("d back", "cache", r"layers/", (), (0.75, 0.75)),
)
log = CS.log


def cards_smi():
    """Each card's ``nvidia-smi`` name and power limit, and the topology."""
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True, timeout=60).stdout.strip().splitlines()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60).stdout
    return q, topo


def sizes(on_card):
    """The configs and depths of a run: published on the card, reduced in
    a CPU rehearsal (T's qwen2-moe there with 12 experts, so that it takes
    the scatter dispatch as at published width)."""
    from repro_torch.configs import get_config

    c13, c70 = get_config("llama2-13b"), get_config("llama2-70b")
    tiny, moe = get_config("tinyllama-1.1b"), get_config("qwen2-moe-a2.7b")
    if on_card:
        return types.SimpleNamespace(
            c13=c13, c70=c70, cut=M4_CUT, steps=M4_STEPS, max_len=1024, cut_steps=CUT_STEPS,
            tiny=tiny, moe=dataclasses.replace(moe, num_layers=T2_LAYERS), l13=c13,
            cut13=dataclasses.replace(c13, num_layers=T3_CUT))
    return types.SimpleNamespace(
        c13=dataclasses.replace(c13.reduced(), num_layers=4),
        c70=dataclasses.replace(c70.reduced(), num_heads=8, num_kv_heads=4),
        cut=1, steps=4, max_len=1024, cut_steps=2, tiny=tiny.reduced(),
        moe=dataclasses.replace(moe.reduced(), num_experts=12), l13=c13.reduced(),
        cut13=dataclasses.replace(c13.reduced(), num_layers=1))


def half_plan(L):
    return [2] * (L // 2) + [1] * (L - L // 2)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_reset(device):
    if device.type == "cuda":
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        return torch.cuda.memory_allocated(device)
    return 0


def peak(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- K: kernel
def kernel_part(c):
    """The paged kernel at this slice's shapes on this rank's card, against
    its plain version; timed on card 0."""
    from repro_torch.kernels import paged_decode as PD

    mid = [n + 16 for n in (600, 32, 200, 96, 130, 64, 300, 80)]
    shapes = {"13b degree 2 (B 4)": (4, 40, 40, 128, mid[:4]),
              "13b degree 4 (B 2)": (2, 40, 40, 128, mid[:2]),
              "70b rank (B 8, H 16, KV 2)": (8, 16, 2, 128, mid)}
    gen = torch.Generator(device=c.device).manual_seed(CS.SEED)
    out = {}
    for what, (B, H, KV, D, lens) in shapes.items():
        errs = []
        for dtype, tol in ((torch.float32, 3e-5), (torch.bfloat16, 2e-2)):
            for ln in (lens, [0] + lens[1:]):
                width = 64
                n_blocks = max(128, sum(-(-n // 16) for n in ln) + 8)
                args = CS.paged_inputs(gen, B, H, KV, D, 16, ln, n_blocks, width, dtype)
                got = PD.paged_decode_attention(*args).float()
                want = PD.paged_decode_attention_ref(*args).float()
                torch.testing.assert_close(got, want, rtol=tol, atol=tol)
                errs.append((got - want).abs().max().item())
        out[what] = {"max_abs_err": max(errs)}
        if c.rank == 0:   # the profiler's trace file is one path: one card times
            shape = types.SimpleNamespace(num_heads=H, num_kv_heads=KV, resolved_head_dim=D)
            ms, plain_ms, bound_ms, bound_by = CS.time_paged_decode(PD, shape, lens, 64,
                                                                    c.smi)
            out[what].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    PD.paged_decode_attention.launches = 0
    return out


# ------------------------------------------------------------------ M1: groups
def m1_part(c):
    """M1 on this rank: backends, collectives against the host, times."""
    import torch.distributed as dist

    from repro_torch.core import replication as R
    from repro_torch.launch import mesh as LM
    from repro_torch.parallel.mesh import RankMesh

    rank, dev = c.rank, c.device
    st = dist.PrefixStore("m1", c.store)
    m14 = RankMesh.build(dist.PrefixStore("m14", st), AXES, (1, WORLD), rank, dev, TIMEOUT)
    m22 = RankMesh.build(dist.PrefixStore("m22", st), AXES, (2, 2), rank, dev, TIMEOUT)
    host = LM.make_host_mesh(dist.PrefixStore("host", st), rank,
                             dev.type if dev.type == "cuda" else "cpu", n=WORLD)
    group = R.ReplicationGroup.build(dist.PrefixStore("repl", st), rank, WORLD, dev, TIMEOUT)
    out = {"backends": {"(1,4) model": m14.groups["model"].name(),
                        "(2,2) data": m22.groups["data"].name(),
                        "(2,2) model": m22.groups["model"].name(),
                        "host data": host.groups["data"].name(),
                        "replication": group.pg.name()},
           "host_device": str(host.device), "capturable": group.capturable,
           "staged": group.staged}
    checks = {}
    n = 1000
    base = np.arange(n, dtype=np.float32)
    mine = np.sin(base + rank).astype(np.float32) * (rank + 1)
    every = [np.sin(base + r).astype(np.float32) * (r + 1) for r in range(WORLD)]
    x = torch.from_numpy(mine).to(dev)
    checks["psum"] = np.allclose(m14.psum(x, "model").cpu().numpy(), np.sum(every, 0),
                                 rtol=1e-6, atol=1e-5)
    checks["pmax"] = np.array_equal(m14.pmax(x, "model").cpu().numpy(), np.max(every, 0))
    checks["mesh all_gather"] = np.array_equal(
        m14.all_gather(x.view(10, 100), "model", 1).cpu().numpy(),
        np.concatenate([e.reshape(10, 100) for e in every], 1))
    d, m = m22.axis_index("data"), m22.axis_index("model")
    y = torch.full((2,), float(10 * d + m), device=dev)
    checks["(2,2) lines"] = (
        m22.psum(y, "model").tolist() == [20 * d + 1] * 2
        and m22.psum(y, "data").tolist() == [10 + 2 * m] * 2)
    full = torch.arange(8 * 6, dtype=torch.float32, device=dev).view(8, 1, 6)
    for deg in (2, 4):
        hook = R.LayerHook([deg], group)
        rows = hook(0, full)
        kv = hook.gather_kv(rows[..., :2], rows[..., 2:])
        checks[f"hook gather degree {deg}"] = (
            torch.equal(hook.full(rows), full) and torch.equal(torch.cat(kv, -1), full))
    outs = [1 + 3 * s + rank for s in range(WORLD)]          # bytes from s
    ins = [1 + 3 * rank + q for q in range(WORLD)]           # bytes to q
    send = torch.cat([torch.full((ins[q],), 16 * rank + q, dtype=torch.uint8)
                      for q in range(WORLD)]).to(dev)
    recv = torch.empty(sum(outs), dtype=torch.uint8, device=dev)
    group.all_to_all(recv, send, outs, ins)
    want = np.concatenate([np.full(outs[s], 16 * s + rank, np.uint8) for s in range(WORLD)])
    checks["uneven uint8 all-to-all"] = np.array_equal(recv.cpu().numpy(), want)
    out["checks"] = checks
    if dev.type != "cuda":
        return out
    buf = torch.zeros(32768, dtype=torch.float32, device=dev)     # 128 KB
    reps = 100
    for _ in range(5):
        group.all_reduce(buf)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        group.all_reduce(buf)
    sync(dev)
    out["eager_128k_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        group.all_reduce(buf)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            group.all_reduce(buf)
    graph.replay()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        graph.replay()
    sync(dev)
    out["graph_128k_ms"] = (time.perf_counter() - t0) * 1e3 / (5 * reps)
    big = torch.ones(1 << 29, dtype=torch.bfloat16, device=dev)    # 1 GiB
    group.all_reduce(big)
    sync(dev)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        group.all_reduce(big)
        sync(dev)
        times.append(time.perf_counter() - t0)
    s = sorted(times)[2]
    out["big"] = {"bytes": big.numel() * 2, "s": s, "alg_GBps": big.numel() * 2 / s / 1e9,
                  "bus_GBps": big.numel() * 2 / s / 1e9 * 2 * (WORLD - 1) / WORLD}
    del big, graph
    free(dev)
    return out


def m1_gates(res, on_card, smi):
    for r, x in res.items():
        want = "nccl" if on_card else "gloo"
        if set(x["backends"].values()) != {want}:
            raise AssertionError(f"M1 rank {r}: backends {x['backends']}")
        if on_card and (x["host_device"] != f"cuda:{r}" or not x["capturable"]
                        or x["staged"]):
            raise AssertionError(f"M1 rank {r}: host mesh on {x['host_device']}, "
                                 f"capturable {x['capturable']}, staged {x['staged']}")
        if not all(x["checks"].values()):
            raise AssertionError(f"M1 rank {r}: {x['checks']}")
    x = res[0]
    log(f"[multicard] M1: every axis line's group {sorted(set(x['backends']))} is "
        f"{x['backends']['replication']} on every rank, make_host_mesh's rank r on "
        f"cuda:r, the replication group capturable and not staged; "
        f"{sorted(x['checks'])} equal the host's on every rank [{smi}]")
    if on_card:
        b = x["big"]
        log(f"[multicard] M1: a 128 KB fp32 all-reduce over 4 cards, 100 back to back: "
            f"{x['eager_128k_ms']:.4f} ms each eagerly, {x['graph_128k_ms']:.4f} ms "
            f"replayed in a CUDA graph (rank 0; ranks 1-3 "
            f"{[round(res[r]['graph_128k_ms'], 4) for r in (1, 2, 3)]}); a 1 GiB bf16 "
            f"all-reduce {b['s'] * 1e3:.2f} ms: {b['alg_GBps']:.1f} GB/s algorithm, "
            f"{b['bus_GBps']:.1f} GB/s bus [{smi}]")


# -------------------------------------------------- M2: replicated llama2-13b
def m2_runs(L):
    half, four = half_plan(L), [4] * L
    return (("degree 1", "quad", {}),
            ("half on 2", "pair", {0: half}),
            ("half on 4", "quad", {0: half}),
            ("four on 4", "quad", {0: four}),
            ("mid-serve", "quad", {0: four, 4: half, 8: [1] * L, 12: four}))


def serve(c, cfg, params, group, plans, graphs, rec=None, check=None):
    """Phase 5's workload through a fresh ``Engine(group=group)``, ``plans[i]``
    applied before step i: per step the tokens, and per steady decode step
    (ms, all-gathers, host syncs, degrees, whether it captured); the
    streams, the pool's checksum and the graph counts. ``rec`` (a
    ``CS.Top2``) records eager decode logits; ``check`` holds every
    paged call of the first steady replicated step against its plain
    version (that step is not timed)."""
    from repro_torch.core import replication as R
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.serving import graphs as GR
    from repro_torch.serving import instrument as INS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import RequestSpec, SamplingParams

    eng = Engine(cfg, params, paged_attn_impl="kernel", device=c.device,
                 cuda_graphs=graphs, group=group, **CS.ENGINE_KW)
    prompts, sampled = CS.workload(cfg)
    reqs = []
    for i, p in enumerate(prompts):
        temp, top_k = (0.8, 8) if i in sampled else (0.0, 0)
        sp = SamplingParams(temperature=temp, top_k=top_k, seed=100 + i)
        reqs.append(eng.submit(RequestSpec(rid=i, prompt=p, max_tokens=32, sampling=sp)))
    PD.paged_decode_attention.launches = 0
    out, chk = {"steady": [], "steps": []}, {}
    strict = graphs and c.device.type == "cuda"
    i = 0
    with rec.installed(eng) if rec else contextlib.nullcontext():
        while eng.queue or eng.active or eng.prefilling:
            if i in plans:
                eng.apply_plan(plans[i])
            steady = not eng.queue and not eng.prefilling
            degrees = eng._step_degrees
            replicated = degrees is not None and max(degrees) > 1
            checked = check is not None and steady and replicated and not chk
            caps = eng.graphs.counts.captures["decode"]
            sync(c.device)
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                n = stack.enter_context(R.count_collectives(group))
                syncs = stack.enter_context(INS.count_host_syncs())
                if checked:
                    stack.enter_context(CS.checked_kernel_calls(chk))
                if steady and strict:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    eng.step()
                finally:
                    if strict:
                        torch.cuda.set_sync_debug_mode(0)
            ms = (time.perf_counter() - t0) * 1e3
            if steady and not checked:
                out["steady"].append({
                    "ms": ms, "gathers": n.get("all-gather", 0), "syncs": syncs.n,
                    "degrees": list(degrees) if replicated else None,
                    "captured": eng.graphs.counts.captures["decode"] > caps})
            out["steps"].append([(r.rid, r.generated[-1] if r.generated else -1)
                                 for r in reqs])
            i += 1
    nb = eng.pstate.k.shape[1] - 1
    g = eng.graphs
    out.update(
        streams={r.rid: r.generated for r in reqs},
        launches=GR.launches_run(PD.paged_decode_attention, [g]),
        decode_steps=eng._step_count,
        counts={k: dict(getattr(g.counts, k)) for k in ("captures", "replays", "eager")},
        decode_keys=len({k for k in g.keys if k[0] == "decode"}),
        pool=(CS.bits_checksum(eng.pstate.k[:, :nb]), CS.bits_checksum(eng.pstate.v[:, :nb])),
        checks=chk.get("paged", []),
    )
    del eng
    free(c.device)
    return out


def m2_part(c):
    """M2 on this rank (module docstring). Returns its measurements and
    keeps the weights on ``c`` for M3 (rank 0's draw)."""
    import torch.distributed as dist

    from repro_torch.core import replication as R
    from repro_torch.models import transformer as T

    rank, dev, cfg = c.rank, c.device, c.sz.c13
    st = dist.PrefixStore("m2", c.store)
    quad = R.ReplicationGroup.build(dist.PrefixStore("quad", st), rank, WORLD, dev, TIMEOUT)
    pair = R.ReplicationGroup.build(dist.PrefixStore(f"pair{rank // 2}", st), rank % 2, 2,
                                    dev, TIMEOUT)
    c.quad = quad
    for g in (quad, pair):    # each communicator made before any step
        g.all_reduce(torch.zeros(1, device=dev))
    t0 = time.perf_counter()
    if rank == 0:
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(CS.SEED),
                               "bfloat16")
    else:
        params = CS._tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                              T.init_params_meta(cfg, "bfloat16"))
    sync(dev)
    out = {"draw_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    R.replicate_params_for_plan(params, quad)
    sync(dev)
    leaves = list(CS.tree_leaves(params))
    out["broadcast"] = (time.perf_counter() - t0, sum(x.numel() * x.element_size()
                                                      for x in leaves))
    out["weights"] = [CS.bits_checksum(x) for x in leaves]
    runs, recs = {}, {}
    for what, grp, plans in m2_runs(cfg.num_layers):
        group = quad if grp == "quad" else pair
        for graphs in (True, False):
            rec = None if graphs else CS.Top2(c.T, cfg)
            check = {} if (not graphs and plans) else None
            runs[(what, graphs)] = serve(c, cfg, params, group, plans, graphs, rec, check)
            if rec is not None:
                recs[what] = rec.rec
    one = runs[("degree 1", False)]["streams"]
    for (what, graphs), r in runs.items():
        if not graphs and what != "degree 1":
            r["flips"] = CS.repl_flips(c.work, one, recs["degree 1"], r["streams"],
                                       recs[what])
    out["runs"] = {f"{what} {'graphs' if g else 'eager'}": r for (what, g), r in runs.items()}
    out["plans"] = {what: plans for what, _, plans in m2_runs(cfg.num_layers)}
    c.params13 = params
    return out


def m2_gates(res, on_card, smi, L):
    bound = 7.673
    r0 = res[0]
    secs, nbytes = r0["broadcast"]
    for r in res:
        if res[r]["weights"] != r0["weights"]:
            raise AssertionError(f"M2: rank {r}'s weights differ from rank 0's")
    log(f"[multicard] M2: llama2-13b ({L} layers, bf16) drawn on rank 0 in "
        f"{r0['draw_s']:.2f} s; replicate_params_for_plan broadcast {nbytes} B over 4 "
        f"cards in {secs:.3f} s ({nbytes / secs / 1e9:.1f} GB/s); every rank's weights "
        f"bit-equal [{smi}]")
    runs0 = r0["runs"]
    for name in runs0:
        what = name.rsplit(" ", 1)[0]
        graphs = name.endswith("graphs")
        plans = r0["plans"][what]
        members = [(0, 1), (2, 3)] if what == "half on 2" else [(0, 1, 2, 3)]
        for ranks in members:
            a = res[ranks[0]]["runs"][name]
            for q in ranks[1:]:
                b = res[q]["runs"][name]
                if a["steps"] != b["steps"] or a["streams"] != b["streams"]:
                    raise AssertionError(f"M2 {name}: ranks {ranks[0]} and {q} differ")
                if a["pool"] != b["pool"]:
                    raise AssertionError(f"M2 {name}: the pools of ranks {ranks[0]} and "
                                         f"{q} differ")
        if what == "half on 2" and res[2]["runs"][name]["streams"] != runs0[name]["streams"]:
            raise AssertionError(f"M2 {name}: the two pairs' streams differ")
        eager_twin = runs0[f"{what} eager"]
        for r in res:
            run = res[r]["runs"][name]
            if on_card and run["launches"] != L * run["decode_steps"]:
                raise AssertionError(f"M2 {name} rank {r}: {run['launches']} paged "
                                     f"launches for {run['decode_steps']} decode steps")
            for s in run["steady"]:
                if s["degrees"] is not None and s["gathers"] != CS.predicted_gathers(
                        s["degrees"]):
                    raise AssertionError(f"M2 {name} rank {r}: {s['gathers']} all-gathers "
                                         f"under {s['degrees']}")
            if graphs and on_card:
                if run["counts"]["eager"].get("decode", 0):
                    raise AssertionError(f"M2 {name} rank {r}: eager decode steps "
                                         f"{run['counts']['eager']}")
                if run["counts"]["captures"].get("decode", 0) != run["decode_keys"]:
                    raise AssertionError(f"M2 {name} rank {r}: {run['counts']['captures']} "
                                         f"captures for {run['decode_keys']} decode keys")
                bad = [s for s in run["steady"] if not s["captured"] and s["syncs"] != 1]
                if bad:
                    raise AssertionError(f"M2 {name} rank {r}: replayed steps with host "
                                         f"syncs {[s['syncs'] for s in bad]}")
            if graphs and run["streams"] != eager_twin["streams"] and r == 0:
                raise AssertionError(f"M2 {what}: graph streams differ from eager ones")
            if not graphs and plans and on_card:
                errs = run["checks"]
                if len(errs) != L or max(errs) > 2e-2:
                    raise AssertionError(f"M2 {name} rank {r}: paged calls of a replicated "
                                         f"step against their plain version {errs}")
            for rid, t, one, rep in run.get("flips", []):
                ok = (one and rep and set(one[1]) == set(rep[1])
                      and abs(one[0][0] - one[0][1]) <= BF16_TIE * max(1.0, abs(one[0][0]))
                      and abs(rep[0][0] - rep[0][1]) <= BF16_TIE * max(1.0, abs(rep[0][0])))
                if not ok:
                    raise AssertionError(f"M2 {name} rank {r}: rid {rid} token {t} flips, "
                                         f"top-2 {one} against {rep}")
        steady = runs0[name]["steady"]
        rep = [s["ms"] for s in steady if s["degrees"] and not s["captured"]]
        one = [s["ms"] for s in steady if not s["degrees"] and not s["captured"]]
        caps = [round(s["ms"], 1) for s in steady if s["captured"]]
        log(f"[multicard] M2 {name}: {runs0[name]['decode_steps']} decode steps, counts "
            f"{runs0[name]['counts']}, {runs0[name]['decode_keys']} decode keys; steady "
            f"step median ms (rank 0): replicated {CS.median(rep):.3f} over {len(rep)}, "
            f"degree 1 {CS.median(one):.3f} over {len(one)} (weight-read bound {bound} ms; "
            f"capture steps {caps}); all-gathers per replicated step "
            f"{sorted({s['gathers'] for s in steady if s['degrees']})}, host syncs per "
            f"steady step {sorted({s['syncs'] for s in steady if not s['captured']})}; "
            f"paged launches {runs0[name]['launches']}; flips {runs0[name].get('flips', [])}; "
            f"worst paged call of a replicated step {max(runs0[name]['checks'], default=0):.3e}; "
            f"tokens equal on every rank at every step, pools bit-equal [{smi}]")


# ------------------------------------------------ M3: re-placement over 4 cards
def m3_part(c):
    """M3 on this rank (module docstring): rank 0 keeps M2's weights (or
    draws them), ranks 1-3 hold meta placeholders."""
    from repro_torch.core import migration as MIG
    from repro_torch.models import transformer as T
    from repro_torch.serving import paged_kv as PK

    rank, dev, cfg, group = c.rank, c.device, c.sz.c13, c.quad
    params = getattr(c, "params13", None)
    c.params13 = None
    if rank:
        params = None
        free(dev)
        trees = {"params": T.init_params_meta(cfg, "bfloat16"),
                 "cache": T.init_cache(cfg, 8, c.sz.max_len, "bfloat16", "meta")}
    else:
        gen = torch.Generator(device=dev).manual_seed(CS.SEED)
        if params is None:
            params = T.init_params(cfg, gen, "bfloat16")
        trees = {"params": params, "cache": T.init_cache(cfg, 8, c.sz.max_len, "bfloat16", dev)}
        for x in trees["cache"]["layers"].values():
            x.normal_(generator=gen)
    del params
    res = {"layers": cfg.num_layers, "moves": [], "expect": {}}
    if rank == 0:
        for _, tree, regex, spec, _ in MOVES:
            for path, leaf in CS.path_leaves(trees[tree], regex):
                for q in range(WORLD):
                    block = MIG.replacement_plan(leaf.shape, None, spec, WORLD).after[q]
                    key = f"{tree}/{path} {block}"
                    if key not in res["expect"]:
                        res["expect"][key] = CS.bits_checksum(
                            leaf[tuple(slice(*b) for b in block)])
        res["logits_before"] = CS.bits_checksum(
            CS.replacement_step(c.T, PK, cfg, trees["params"], dev))
    group.all_reduce(torch.zeros(1, device=dev))      # every rank starts together
    # the group's first all-to-all sets up NCCL's point-to-point channels:
    # timed apart, so the moves time their transfers
    sync(dev)
    t0 = time.perf_counter()
    one = torch.zeros(WORLD, dtype=torch.uint8, device=dev)
    group.all_to_all(torch.empty_like(one), one, [1] * WORLD, [1] * WORLD)
    sync(dev)
    res["first_a2a_s"] = time.perf_counter() - t0
    launches = c.PD.paged_decode_attention.launches
    pending = []
    for i, (step, tree, regex, spec, _) in enumerate(MOVES):
        planned = MIG.planned_bytes(trees[tree], regex, spec, WORLD, rank)
        counts, received = collections.Counter(group.counts), group.bytes_received
        if step == "a" and "a_base" not in res:
            res["a_base"] = peak_reset(dev)
        move = MIG.migrate_kv_cache if tree == "cache" else functools.partial(
            MIG.migrate_by_path, path_regex=regex)
        trees[tree], cost = move(trees[tree], new_spec=spec, group=group, measure=True)
        res["moves"].append({
            "step": step, "regex": regex, "spec": spec, "planned": planned,
            "received": group.bytes_received - received,
            "collectives": dict(group.counts - counts), "moved": cost.bytes_moved,
            "seconds": cost.measured_seconds, "estimate": cost.est_seconds})
        leaves = {}
        for path, leaf in CS.path_leaves(trees[tree], regex):
            block = MIG.replacement_plan(MIG.placement_of(leaf).shape, None, spec,
                                         WORLD).after[rank]
            leaves[f"{tree}/{path} {block}"] = leaf
        pending.append((res["moves"][-1], leaves))
        if i + 1 < len(MOVES) and MOVES[i + 1][0] == step:
            continue
        if step == "a":
            res["a_peak"] = peak(dev)
            res["a_shards"] = sum(x.numel() * x.element_size() for x in CS.tree_leaves(
                trees["params"]["layers"]["attn"]))
        for record, done in pending:
            record["checksums"] = {k: CS.bits_checksum(x) for k, x in done.items()}
        pending.clear()
    res["logits"] = CS.bits_checksum(CS.replacement_step(c.T, PK, cfg, trees["params"], dev))
    res["launches"] = c.PD.paged_decode_attention.launches - launches
    del trees
    free(dev)
    return res


def m3_gates(res, on_card, smi):
    r0 = res[0]
    L, expect = r0["layers"], r0["expect"]
    fit = []
    for i, (step, _, regex, spec, share) in enumerate(MOVES):
        moves = {r: res[r]["moves"][i] for r in res}
        for r, m in moves.items():
            want = share[0 if r == 0 else 1] * m["moved"]
            if not m["received"] == m["planned"] == want:
                raise AssertionError(f"M3 {step} {regex} rank {r}: received {m['received']} "
                                     f"B, the plan {m['planned']} B, the share {want} B")
            for key, ck in m["checksums"].items():
                if expect.get(key) != ck:
                    raise AssertionError(f"M3 {step} rank {r}: {key} is not rank 0's "
                                         f"original slice")
            n_leaves = len(m["checksums"])
            if step == "c split":
                if m["collectives"]:
                    raise AssertionError(f"M3 {step} rank {r}: {m['collectives']}")
            elif m["collectives"] != {"all-to-all": n_leaves}:
                raise AssertionError(f"M3 {step} rank {r}: {m['collectives']}, one "
                                     f"all-to-all a leaf")
        secs = max(m["seconds"] for m in moves.values())
        got = max(m["received"] for m in moves.values())
        if got:
            fit.append((got, secs))
        log(f"[multicard] M3 move {i} ({step}): {regex} -> {spec}: bytes_moved "
            f"{moves[0]['moved']} B; received by rank "
            f"{ {r: m['received'] for r, m in moves.items()} } B (= the plan's); "
            f"{secs:.4f} s (slowest rank), {got / secs / 1e9 if secs else 0:.1f} GB/s into "
            f"the fullest rank; estimate_cost {moves[0]['estimate']:.3f} s; leaves bit-equal "
            f"to rank 0's original slices [{smi}]")
    if on_card:
        for r in (1, 2, 3):
            grew = res[r]["a_peak"] - res[r]["a_base"]
            if grew > res[r]["a_shards"] + CS.REPLACE_SLACK:
                raise AssertionError(f"M3 (a): rank {r}'s peak grew {grew} B for "
                                     f"{res[r]['a_shards']} B of shards")
        log(f"[multicard] M3 (a) on ranks 1-3 (meta placeholders): peak grew "
            f"{[res[r]['a_peak'] - res[r]['a_base'] for r in (1, 2, 3)]} B for their "
            f"{res[1]['a_shards']} B of attention shards (gate: + {CS.REPLACE_SLACK} B)")
    logits = {r: res[r]["logits"] for r in res}
    if any(v != r0["logits_before"] for v in logits.values()):
        raise AssertionError(f"M3 (e): logits {logits}, before any move {r0['logits_before']}")
    if on_card and any(res[r]["launches"] != L for r in res):
        raise AssertionError(f"M3 (e): paged launches {[res[r]['launches'] for r in res]}")
    if len(fit) >= 2:
        (b0, s0), (b1, s1) = min(fit), max(fit)
        bw = (b1 - b0) / (s1 - s0) if s1 > s0 else float("inf")
        fixed = s0 - b0 / bw
        log(f"[multicard] M3: a line through the smallest and the largest move: "
            f"{bw / 1e9:.1f} GB/s and {fixed * 1e3:.2f} ms fixed, against "
            f"estimate_cost's 50 GB/s and 240 ms (defaults unchanged)")
    log(f"[multicard] M3: the group's first all-to-all (4 B a rank, NCCL's point-to-point "
        f"set-up) {[round(res[r]['first_a2a_s'], 3) for r in res]} s, before the moves")
    log(f"[multicard] M3 (e): one paged step (8 rows) on the re-placed {L}-layer llama2-13b: "
        f"logits bit-equal on all 4 ranks and to rank 0's unmoved step; paged launches "
        f"{[res[r]['launches'] for r in res]} [{smi}]")


# -------------------------------------------- M4: llama2-70b tensor-parallel
def m4_prefill(c, cfg, params, rules, mesh, n_blocks, steps, dtype):
    """Phase 5's prompts prefilled under ``rules`` into this rank's pool:
    (pool state, first tokens [B], prompt lengths)."""
    from repro_torch.parallel import sharding as SH
    from repro_torch.serving import paged_kv as PK

    T, dev = c.T, c.device
    prompts, _ = CS.workload(cfg)
    toks, lens = CS.padded_prompts(prompts, dev)
    B = len(prompts)
    with SH.use_rules(rules):
        cache = T.init_cache_shard(cfg, B, toks.shape[1], rules, mesh, dtype, dev)
        lg = T.forward(params, cfg, toks, cache=cache, mode="prefill",
                       last_idx=(lens - 1).long(), attn_impl="kernel")[0]
    first = lg[:, :cfg.vocab_size].argmax(-1)
    pst = PK.init_paged_shard(cfg, B, n_blocks, rules, mesh, block_size=16, dtype=dtype,
                              max_len=c.sz.max_len, device=dev)
    n = [len(p) for p in prompts]
    CS.paged_rows(cache, list(range(B)), slice(None), pst, list(range(B)), n, steps)
    del cache, lg
    return pst, first, n


def m4_handle(T, pst, dev):
    B = pst.block_tables.shape[0]
    return {"k": pst.k, "v": pst.v, "block_tables": T.to_device(pst.block_tables, dev),
            "lengths": T.to_device(pst.lengths, dev),
            "active": torch.ones((B,), dtype=torch.bool, device=dev)}


def m4_part(c):
    """M4 on this rank (module docstring)."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models import layers as LY
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.mesh import RankMesh
    from repro_torch.serving import graphs as GR
    from repro_torch.serving import instrument as INS

    T, PD, rank, dev, cfg = c.T, c.PD, c.rank, c.device, c.sz.c70
    V, steps, on_card = cfg.vocab_size, c.sz.steps, dev.type == "cuda"
    mesh = RankMesh.build(dist.PrefixStore("m4", c.store), AXES, (1, WORLD), rank, dev, TIMEOUT)
    rules = dict(SH.rules_for(cfg, mesh), mesh=mesh)
    out = {"backend": mesh.groups["model"].name(), "rules": {
        k: v for k, v in rules.items() if k != "mesh"}}
    base = peak_reset(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    shard = T.init_params_shard(cfg, gen, rules, mesh, "bfloat16")
    sync(dev)
    out["draw"] = {"s": time.perf_counter() - t0, "shard": tree_bytes(shard),
                   "grew": peak(dev) - base, "chunk": 4 * LY.DRAW_ELEMS,
                   "wq": tuple(shard["layers"]["attn"]["wq"].shape),
                   "wk": tuple(shard["layers"]["attn"]["wk"].shape)}
    # phase 5's prompts prefilled under rules, then the decode steps
    pst, first, lens = m4_prefill(c, cfg, shard, rules, mesh, 512, steps, "bfloat16")
    out["pool"] = {"shape": tuple(pst.k.shape), "bytes": 2 * pst.k.numel() * pst.k.element_size()}
    snap = (pst.k.clone(), pst.v.clone(), pst.lengths.copy())
    handle = m4_handle(T, pst, dev)
    eager = {"logits": [], "tok": [first], "colls": [], "launches": [], "ms": [],
             "checks": {}}
    with SH.use_rules(rules):
        for t in range(steps):
            before = collections.Counter(mesh.collectives)
            l0 = PD.paged_decode_attention.launches
            check = t == min(3, steps - 1)
            with CS.checked_kernel_calls(eager["checks"]) if check else contextlib.nullcontext():
                sync(dev)
                t1 = time.perf_counter()
                lg, handle, _ = T.forward_paged(shard, cfg, eager["tok"][-1][:, None], handle,
                                                attn_impl="kernel")
                sync(dev)
            if not check:
                eager["ms"].append((time.perf_counter() - t1) * 1e3)
            eager["colls"].append(dict(mesh.collectives - before))
            eager["launches"].append(PD.paged_decode_attention.launches - l0)
            eager["logits"].append(lg[:, :V].float())
            eager["tok"].append(lg[:, :V].argmax(-1))
    # the same steps from the same state as one CUDA graph, replayed
    pst.k.copy_(snap[0])
    pst.v.copy_(snap[1])
    del snap
    lengths0 = T.to_device(pst.lengths, dev)
    tables, active = handle["block_tables"], handle["active"]

    def step_fn(tok, lengths):
        h = {"k": pst.k, "v": pst.v, "block_tables": tables, "lengths": lengths,
             "active": active}
        return T.forward_paged(shard, cfg, tok, h, attn_impl="kernel")[0][:, :V].float()

    graphs = GR.StepGraphs(dev, tally=mesh.collectives, capture_error_mode="thread_local")
    PD.paged_decode_attention.launches = 0
    graph = {"tok": [first], "colls": [], "syncs": [], "ms": [], "diff": []}
    lengths = lengths0
    prof_at = steps - 4 if on_card and rank == 0 else None
    with SH.use_rules(rules):
        for t in range(steps):
            before = collections.Counter(mesh.collectives)
            sync(dev)
            replay = t > 0
            strict = replay and on_card and t != prof_at
            if strict:
                torch.cuda.set_sync_debug_mode("error")
            try:
                with INS.count_host_syncs() as syncs, (
                        profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                        if t == prof_at else contextlib.nullcontext()) as p:
                    t1 = time.perf_counter()
                    lg = graphs.run(("m4",), step_fn, graph["tok"][-1][:, None], lengths)
                    nxt = lg.argmax(-1)
                    INS.fetch(nxt)            # the step's one host sync
                    ms = (time.perf_counter() - t1) * 1e3
            finally:
                if strict:
                    torch.cuda.set_sync_debug_mode(0)
            if t == prof_at:
                trace = c.out_dir / "m4_graph_step_trace_rank0.json"
                p.export_chrome_trace(str(trace))
                n_ops, busy, by_name = CS.device_time(trace)

                def kind_ms(*marks):
                    return sum(v for k, v in by_name.items()
                               if any(m in k.lower() for m in marks)) / 1e3

                out["profile"] = {"ops": n_ops, "wall_ms": ms, "busy_ms": busy / 1e3,
                                  "nccl_ms": kind_ms("nccl"),
                                  "gemm_ms": kind_ms("nvjet", "gemm", "splitkreduce"),
                                  "paged_ms": kind_ms("split_decode")}
            graph["diff"].append((lg != eager["logits"][t]).any())
            graph["colls"].append(dict(mesh.collectives - before))
            graph["syncs"].append(syncs.n)
            if replay and t != prof_at:
                graph["ms"].append(ms)
            graph["tok"].append(nxt)
            lengths = lengths + 1
    out["graph_launches"] = GR.launches_run(PD.paged_decode_attention, [graphs])
    out["counts"] = {k: dict(getattr(graphs.counts, k)) for k in ("captures", "replays")}
    out["eager"] = {"colls": eager["colls"], "launches": eager["launches"], "ms": eager["ms"],
                    "checks": eager["checks"].get("paged", [])}
    out["graph"] = {"colls": graph["colls"], "syncs": graph["syncs"], "ms": graph["ms"]}
    out["bitequal"] = not bool(torch.stack(graph["diff"]).any())
    out["streams_equal"] = bool(torch.equal(torch.stack(eager["tok"], 1),
                                            torch.stack(graph["tok"], 1)))
    out["tokens"] = torch.stack(eager["tok"], 1).tolist()
    out["finite"] = bool(torch.isfinite(torch.stack(eager["logits"])).all())
    del shard, pst, handle, eager, graph, graphs, lg
    free(dev)
    out["cut"] = m4_cut(c, mesh)
    return out


def m4_cut(c, mesh):
    """The fp32 cut: ``c.sz.cut`` layers of llama2-70b, TF32 off, sharded
    under rules on every rank against the unsharded step on rank 0 (fed
    the sharded tokens): the prefill's and each decode step's logits."""
    from repro_torch.parallel import sharding as SH
    from repro_torch.serving import paged_kv as PK

    T, rank, dev = c.T, c.rank, c.device
    cfg = dataclasses.replace(c.sz.c70, num_layers=c.sz.cut)
    V, steps = cfg.vocab_size, c.sz.cut_steps
    rules = dict(SH.rules_for(cfg, mesh), mesh=mesh)
    shard = CS.widened(T.init_params_shard(
        cfg, torch.Generator(device=dev).manual_seed(CS.SEED), rules, mesh, "bfloat16"))
    pst, first, lens = m4_prefill(c, cfg, shard, rules, mesh, 128, steps, "float32")
    # the prefill's logits: the first token's, all-gathered over the vocab
    handle = m4_handle(T, pst, dev)
    logits, toks = [], [first]
    with SH.use_rules(rules):
        for _ in range(steps):
            lg, handle, _ = T.forward_paged(shard, cfg, toks[-1][:, None], handle,
                                            attn_impl="kernel")
            logits.append(lg[:, :V].float())
            toks.append(lg[:, :V].argmax(-1))
    del shard, pst, handle
    free(dev)
    out = {"layers": cfg.num_layers, "steps": steps}
    if rank == 0:
        full = T.init_params(cfg, torch.Generator(device=dev).manual_seed(CS.SEED), "bfloat16")
        full = CS._tree_map(lambda x: x.float(), full)
        out["unsharded_bytes"] = sum(x.numel() * x.element_size() for x in CS.tree_leaves(full))
        prompts, _ = CS.workload(cfg)
        toks_p, lens_t = CS.padded_prompts(prompts, dev)
        cache = T.init_cache(cfg, len(prompts), toks_p.shape[1], "float32", dev)
        lg = T.forward(full, cfg, toks_p, cache=cache, mode="prefill",
                       last_idx=(lens_t - 1).long(), attn_impl="kernel")[0]
        out["first_equal"] = bool(torch.equal(lg[:, :V].argmax(-1), first))
        ust = PK.init_paged(cfg, len(prompts), 128, block_size=16, dtype="float32",
                            max_len=c.sz.max_len, device=dev)
        CS.paged_rows(cache, list(range(len(prompts))), slice(None), ust,
                      list(range(len(prompts))), lens, steps)
        del cache
        uh = m4_handle(T, ust, dev)
        rel = []
        for t in range(steps):
            ulg, uh, _ = T.forward_paged(full, cfg, toks[t][:, None], uh, attn_impl="kernel")
            rel.append(CS.rel_l2(logits[t], ulg[:, :V]))
        out["rel"] = rel
        del full, ust, uh
        free(dev)
    mesh.psum(torch.zeros(1, device=dev), "model")    # every rank waits for rank 0
    return out


def m4_gates(res, on_card, smi, L):
    want = {"all-reduce": 1 + 2 * L, "all-gather": 1}
    for r, x in res.items():
        if x["backend"] != ("nccl" if on_card else "gloo"):
            raise AssertionError(f"M4 rank {r}: backend {x['backend']}")
        d = x["draw"]
        if on_card and d["grew"] > d["shard"] + d["chunk"] + CS.REPLACE_SLACK:
            raise AssertionError(f"M4 rank {r}: the sharded draw's peak grew {d['grew']} B "
                                 f"for {d['shard']} B of shards")
        if not (x["bitequal"] and x["streams_equal"] and x["finite"]):
            raise AssertionError(f"M4 rank {r}: graph logits bit-equal {x['bitequal']}, "
                                 f"streams equal {x['streams_equal']}, finite {x['finite']}")
        if x["tokens"] != res[0]["tokens"]:
            raise AssertionError(f"M4 rank {r}: tokens differ from rank 0's")
        for kind in ("eager", "graph"):
            if any(cl != want for cl in x[kind]["colls"]):
                raise AssertionError(f"M4 rank {r} {kind}: collectives a step "
                                     f"{x[kind]['colls']}, want {want}")
        if on_card:
            steps = len(x["eager"]["launches"])
            if set(x["eager"]["launches"]) != {L} or x["graph_launches"] != L * steps:
                raise AssertionError(f"M4 rank {r}: paged launches {x['eager']['launches']} "
                                     f"eager, {x['graph_launches']} in graphs")
            if x["graph"]["syncs"][1:] != [1] * (steps - 1):
                raise AssertionError(f"M4 rank {r}: host syncs {x['graph']['syncs']}")
            if x["counts"]["captures"] != {"m4": 1}:
                raise AssertionError(f"M4 rank {r}: {x['counts']}")
            errs = x["eager"]["checks"]
            if len(errs) != L or max(errs) > 2e-2:
                raise AssertionError(f"M4 rank {r}: paged calls against plain {errs}")
    x = res[0]
    d = x["draw"]
    bound = d["shard"] / CS.HBM_BYTES_PER_S * 1e3
    log(f"[multicard] M4: llama2-70b ({L} layers) on (data 1, model 4), rules "
        f"{x['rules']}; each rank's shards {[res[r]['draw']['shard'] for r in res]} B drawn "
        f"in {[round(res[r]['draw']['s'], 2) for r in res]} s (wq {d['wq']}, wk {d['wk']}), "
        f"the draw's peak grew {[res[r]['draw']['grew'] for r in res]} B (gate: the shard + "
        f"one fp32 chunk of {d['chunk']} B + {CS.REPLACE_SLACK} B); pool {x['pool']} [{smi}]")
    prof = x.get("profile", {})
    log(f"[multicard] M4: {len(x['eager']['ms']) + 1} greedy paged decode steps under rules: "
        f"eager median {CS.median(x['eager']['ms']):.3f} ms, graph replay median "
        f"{CS.median(x['graph']['ms']):.3f} ms (rank 0; ranks 1-3 "
        f"{[round(CS.median(res[r]['graph']['ms']), 3) for r in (1, 2, 3)]}) against the "
        f"per-rank weight-read bound {bound:.3f} ms ({d['shard']} B at 3.35 TB/s); replayed "
        f"logits bit-equal to the eager step's on every rank, streams equal; collectives a "
        f"step {want}; paged launches {x['eager']['launches'][0]} a step, "
        f"{x['graph_launches']} over the graph run; host syncs per replayed step 1; worst "
        f"paged call against plain {max(x['eager']['checks'], default=0):.3e}; profiled "
        f"replay (rank 0): {prof} [{smi}]")
    cut = x["cut"]
    if not cut["first_equal"] or max(cut["rel"]) > 1e-4:
        raise AssertionError(f"M4 fp32 cut: {cut}")
    log(f"[multicard] M4 fp32 cut ({cut['layers']} of {L} layers, TF32 off, unsharded "
        f"{cut['unsharded_bytes']} B on card 0): first tokens equal, {cut['steps']} decode "
        f"steps' logits against the unsharded step, relative L2 "
        f"{[f'{e:.2e}' for e in cut['rel']]} (tol 1e-4) [{smi}]")


# ------------------------------------ T: the sharded train step across cards
def t_settings(device):
    """Phase 15's sizes (``CS.p15_settings``), every fp32 run at 3 steps
    on the card."""
    st = CS.p15_settings(device)
    if not st["reduced"]:
        st.update(moe_steps=3, ep_steps=3)
    return st


def t_cases(sz):
    """Part T's cases but the full-depth llama2-13b: (name, store tag,
    ``p15_predicted`` part, config, mesh, ``p15_part`` options)."""
    t1 = dict(bf16=True, witness=True)
    return (("T1 (1, 4)", "T1-1x4", "tp", sz.tiny, (1, WORLD), t1),
            ("T1 (4, 1)", "T1-4x1", "dp", sz.tiny, (WORLD, 1), t1),
            ("T1 (2, 2)", "T1-2x2", "2d", sz.tiny, (2, 2), t1),
            ("T2 scatter", "T2-scatter", "moe", sz.moe, (WORLD, 1), dict(compare_at=1)),
            ("T2 all-to-all", "T2-a2a", "ep", sz.moe, (WORLD, 1),
             dict(extra={"moe_a2a": True}, ref=False, repeat=True)),
            ("T3 fp32 cut", "T3-cut", "tp", sz.cut13, (1, WORLD), {}))


def t_part(c):
    """T on this rank (module docstring): phase 15's machinery
    (``CS.p15_part``), each rank's unsharded twin on its own card at the
    same time, then the full-depth llama2-13b."""
    import torch.distributed as dist

    from repro_torch.configs import InputShape
    from repro_torch.data import pipeline as DP
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch import dryrun as DR
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.mesh import RankMesh
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train as TR

    kernels = (c.PD.paged_decode_attention, FA.flash_attention, DA.decode_attention,
               SS.ssd_scan)
    before = [k.launches for k in kernels]
    dev, on_card = c.device, c.device.type == "cuda"
    st = t_settings(dev)
    mods = (c.T, SH, OPT, TR, DP, DR, RankMesh, InputShape)
    store = dist.PrefixStore("T", c.store)

    def trace(tag):   # the profiler's trace file is one path: rank 0 profiles
        return c.out_dir / f"train_step_trace_{tag}_rank0.json" if on_card and not c.rank else None

    out = {"warm": t_warm_up(c, store)}
    for name, tag, part, cfg, shape, kw in t_cases(c.sz):
        t0 = time.perf_counter()
        r = CS.p15_part(mods, st, store, c.rank, WORLD, dev, tag, cfg, shape, trace=trace(tag),
                        **kw)
        r["predicted"] = CS.p15_predicted(c.T, cfg, part, shape)
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
        free(dev)
    t0 = time.perf_counter()
    out["T3 full"] = t3_full(c, st, mods, store, trace("T3-full"))
    out["T3 full"]["seconds"] = time.perf_counter() - t0
    out["launches"] = (before, [k.launches for k in kernels])
    return out


def t_warm_up(c, store):
    """One backward through an NCCL all-reduce before the cases, its host
    syncs counted: a process's first backward on the card starts
    autograd's device thread, whose first collective and events the
    first case's first step would otherwise pay for."""
    import torch.distributed as dist

    from repro_torch.parallel.mesh import RankMesh

    dev = c.device
    mesh = RankMesh.build(dist.PrefixStore("T-warm", store), AXES, (1, WORLD), c.rank, dev,
                          TIMEOUT)
    out = {"groups_s": CS.warm_groups(mesh, dev)}
    x = torch.ones(8, device=dev, requires_grad=True)
    with CS.counted_syncs() if dev.type == "cuda" else contextlib.nullcontext() as found:
        with torch.enable_grad():
            y = mesh.psum(mesh.enter(x, "model") * 2, "model", grad="psum")
            y.sum().backward()
    sync(dev)
    out["syncs"] = list(found or [])
    return out


def t3_full(c, st, mods, store, trace):
    """llama2-13b at published width and depth on (1, 4): bf16 shards
    from the sharded draw, fp32 moments, ``bf16_steps`` steps on one
    repeated batch; the dry run's count, bytes and memory of the case."""
    import torch.distributed as dist

    T, SH, OPT, TR, DP, DR, RankMesh, InputShape = mods
    cfg, dev, rank, shape = c.sz.l13, c.device, c.rank, (1, WORLD)
    mesh = RankMesh.build(dist.PrefixStore("T3-full", store), AXES, shape, rank, dev, TIMEOUT)
    out = {"shape": shape, "layers": cfg.num_layers, "warm_s": CS.warm_groups(mesh, dev),
           "predicted": CS.p15_predicted(T, cfg, "tp", shape)}
    rules = dict(SH.rules_for(cfg, mesh), mesh=mesh)
    _, drules, dstep, dargs = DR.input_specs(
        cfg.name, InputShape("T3-full", "train", st["seq"], st["batch"]),
        RankMesh.dry(AXES, shape, rank), dtype="bfloat16", moments_dtype="float32",
        cfg_override=cfg, remat=False)
    out["dry_bytes"] = DR.tree_bytes(dargs[0]) + DR.tree_bytes(dargs[1])
    _, dtally, out["dry_memory"] = DR.run_step(drules, dstep, dargs)
    out["dry"] = CS.tally_counts(dtally)
    del dargs
    CS.reset_peak(dev)
    t0 = time.perf_counter()
    params = T.init_params_shard(cfg, torch.Generator(device=dev).manual_seed(CS.SEED), rules,
                                 mesh, "bfloat16")
    sync(dev)
    out["draw_s"] = time.perf_counter() - t0
    CS.reset_peak(dev)
    out["start"] = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    opt = OPT.init_opt_state(params)
    batch = next(DP.sharded_batches(cfg, DP.DataConfig(seq_len=st["seq"],
                                                       global_batch=st["batch"]),
                                    mesh, SH.batch_specs(rules)["tokens"], 1))
    ocfg = OPT.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    with SH.use_rules(rules):
        params, opt, run = CS.p15_timed_steps(
            TR.make_train_step(cfg, ocfg), params, opt, [batch] * st["bf16_steps"], mesh, dev,
            trace=trace)
    out["bytes"] = sum(x.numel() * x.element_size()
                       for x in [*CS.tree_leaves(params), *CS.tree_leaves(opt)])
    out.update(run, peak=peak(dev))
    del params, opt, batch
    free(dev)
    return out


def t_warm_ms(xs, r):
    """The steps' ms after the first (warm-up), the profiled one left
    out."""
    skip = r.get("profile", {}).get("step")
    return [x for i, x in enumerate(xs) if i and i != skip]


def t_coll(r, skip=None):
    """Median collective ms a warm step, by phase, and of the logits'
    all-gather (a zero-filled all-reduce W times its bytes)."""
    kept = [i for i in range(len(r["coll_ms"])) if i and i != skip]
    out = {ph: CS.median([r["coll_ms"][i].get(ph, 0.0) for i in kept])
           for ph in ("forward", "backward", "update")}
    out["all-gather"] = CS.median([r["kind_ms"][i].get("forward all-gather", 0.0)
                                   for i in kept])
    return {k: round(v, 3) for k, v in out.items()}


def t_syncs_gate(res, name, twin):
    """Raises where a step of ``name``'s sharded runs made more host syncs
    on a rank than the fewest a step of the unsharded twin ``twin`` made
    there."""
    for r, x in res.items():
        most = min(res[r][twin]["ref_syncs"])
        runs = [x[name], x[name].get("bf16", {"syncs": [], "sync_sites": []})]
        over = [sites for run in runs for n, sites in zip(run["syncs"], run["sync_sites"])
                if n > most]
        if over:
            raise AssertionError(
                f"T {name} rank {r}: host syncs a step {[run['syncs'] for run in runs]}, the "
                f"unsharded step's {res[r][twin]['ref_syncs']} (at "
                f"{res[r][twin]['ref_sync_sites'][0]}); the steps over it synchronised at "
                f"{over}")


def t_gates(res, on_card, smi, sz):
    """Part T's gates on every rank and its lines, case by case; raises
    after the last case if any failed."""
    twins = {"T2 all-to-all": "T2 scatter", "T3 full": "T3 fp32 cut"}
    failed = []
    if on_card:
        log(f"[multicard] T: a backward through an NCCL all-reduce before the cases (autograd's "
            f"device thread, its first collective and events) synchronised at "
            f"{[res[r]['warm']['syncs'] for r in res]} by rank; the group's warm-up s "
            f"{[round(sum(res[r]['warm']['groups_s'].values()), 3) for r in res]} [{smi}]")
    for name, *_ in t_cases(sz):
        try:
            t_case_gates(res, on_card, smi, name, twins)
        except AssertionError as e:
            log(f"[multicard] T {name} FAILED: {e}")
            failed.append(name)
    try:
        t3_gates(res, on_card, smi, twins)
    except AssertionError as e:
        log(f"[multicard] T3 full FAILED: {e}")
        failed.append("T3 full")
    for r, x in res.items():
        a, b = x["launches"]
        if a != b:
            log(f"[multicard] T rank {r}: kernel launches {a} -> {b}")
            failed.append(f"launches rank {r}")
    log(f"[multicard] T: kernel launches (paged, flash, decode, SSD) before -> after part T, "
        f"by rank: { {r: res[r]['launches'] for r in sorted(res)} } (training takes the plain "
        f"routes)")
    if failed:
        raise AssertionError(f"T cases {failed} failed their gates")


def t_case_gates(res, on_card, smi, name, twins):
    """One case of part T: its lines, then its gates on every rank."""
    r0 = res[0][name]
    syncs = [r0["syncs"], r0.get("bf16", {}).get("syncs", [])] if on_card else None
    prof = r0.get("profile") or r0.get("bf16", {}).get("profile")
    nbytes = {ph: {k: v["bytes"] for k, v in by.items()} for ph, by in r0["tally"][0].items()}
    line = (f"[multicard] T {name}: {r0['layers']} layers, fp32 on {r0['shape']}; "
            f"collectives a step {r0['predicted']} = predicted = the dry run's on every "
            f"rank, their bytes (rank 0) {nbytes}; params + moments "
            f"{[res[r][name]['bytes'] for r in res]} B by rank = the dry run's; group "
            f"warm-up s (rank 0) { {k: round(v, 3) for k, v in r0['warm_s'].items()} }; "
            f"step ms (rank 0) {CS.fmt_ms(r0['ms'])}, collective ms a warm step by phase "
            f"(rank 0; CUDA events on NCCL, the host clock on gloo) "
            f"{t_coll(r0, r0.get('profile', {}).get('step'))}, beside {STEP14}; peak B by "
            f"rank {[res[r][name]['peak'] for r in res]}")
    if "ref_loss" in r0:
        errs = {f"{k} (rank {r})": v for r in res for k, v in res[r][name]["errs"].items()}
        worst = max(errs, key=errs.get)
        line += (f"; the unsharded twin on each rank's card {CS.fmt_ms(r0['ref_ms'])} ms "
                 f"(peak {r0['ref_peak']} B); losses {[f'{v:.6f}' for v in r0['loss']]} "
                 f"against {[f'{v:.6f}' for v in r0['ref_loss']]}; worst shard after step "
                 f"{r0['compared_steps']} over the ranks {worst} {errs[worst]:.3e} "
                 + ("(ungated: the float64 witness gates the shards)" if "f64" in r0
                    else "(tol 1e-4)"))
        if r0["route_flips"]:
            line += f"; tokens whose expert ids flip by step and layer {r0['route_flips']}"
    else:
        line += (f"; losses {[f'{v:.4f}' for v in r0['loss']]} on one repeated batch, aux "
                 f"{[f'{v:.4f}' for v in r0['aux']]}")
    if syncs is not None:
        line += (f"; host syncs a step (rank 0; fp32, bf16) {syncs}, the unsharded twin's "
                 f"{res[0][twins.get(name, name)]['ref_syncs']}")
    log(line + f"; case {r0['seconds']:.1f} s [{smi}]")
    if "bf16" in r0:
        b = r0["bf16"]
        log(f"[multicard] T {name}, bf16: {len(b['loss'])} steps on one repeated batch, loss "
            f"{b['loss'][0]:.4f} -> {b['loss'][-1]:.4f} (gate: falls more than "
            f"{CS.TRAIN_FALL}), step ms (rank 0) {CS.fmt_ms(b['ms'])}, warm median "
            f"{CS.median(t_warm_ms(b['ms'], b)):.1f}, collective ms a warm step "
            f"{t_coll(b, b.get('profile', {}).get('step'))}, peak B by rank "
            f"{[res[r][name]['bf16']['peak'] for r in res]} [{smi}]")
    if prof:
        log(f"[multicard] T {name}: profiled step (rank 0, the last of its last run): "
            f"{prof['wall_ms']:.1f} ms wall, {prof['busy_ms']:.1f} ms device busy over "
            f"{prof['ops']} device ops, NCCL kernels {prof['nccl_ms']:.2f} ms "
            f"({prof['nccl_ms'] / prof['wall_ms']:.1%} of the step) [{smi}]")
    for ln in CS.witness_lines(f"T {name}", [res[r][name] for r in sorted(res)]):
        log(f"{ln.replace('[sharded-train]', '[multicard]')} [{smi}]")
    for r, x in res.items():
        CS.p15_gates(f"T {name} rank {r}", x[name], on_card)
        if "f64" in x[name]:   # the float32 shards after step 1 too, as without it
            k, v = x[name]["errs_steps"][1]
            if v > 1e-4:
                raise AssertionError(f"T {name} rank {r}: {k} {v:.3e} from the unsharded "
                                     f"step after step 1 (tol 1e-4)")
        for i, t in enumerate(x[name].get("bf16", {}).get("tally", [])):
            if CS.tally_counts(t) != x[name]["predicted"]:
                raise AssertionError(f"T {name} rank {r}: bf16 step {i}'s collectives "
                                     f"{CS.tally_counts(t)}, predicted "
                                     f"{x[name]['predicted']}")
        if any(abs(a - b) > 1e-6 * abs(b) for a, b in zip(x[name]["loss"],
                                                           res[0][name]["loss"])):
            raise AssertionError(f"T {name}: rank {r}'s losses {x[name]['loss']}, rank "
                                 f"0's {res[0][name]['loss']}")
    if on_card:
        t_syncs_gate(res, name, twins.get(name, name))


def t3_gates(res, on_card, smi, twins):
    """T3 at published depth: its lines, then its gates on every rank."""
    name = "T3 full"
    t = res[0][name]
    log(f"[multicard] T3 full: llama2-13b at {t['layers']} layers on {t['shape']}, bf16 shards "
        f"from the sharded draw ({t['draw_s']:.2f} s, rank 0) and fp32 moments: params + "
        f"moments {[res[r][name]['bytes'] for r in res]} B by rank (the dry run's "
        f"{t['dry_bytes']}); collectives a step {CS.tally_counts(t['tally'][0])}, predicted "
        f"{t['predicted']}, the dry run's {t['dry']}; {len(t['loss'])} steps on one repeated "
        f"batch, loss {t['loss'][0]:.4f} -> {t['loss'][-1]:.4f} (gate: falls more than "
        f"{CS.TRAIN_FALL}); step ms (rank 0) {CS.fmt_ms(t['ms'])}, warm median "
        f"{CS.median(t_warm_ms(t['ms'], t)):.1f}, collective ms a warm step "
        f"{t_coll(t, t.get('profile', {}).get('step'))}; peak B by rank "
        f"{[res[r][name]['peak'] for r in res]}; host syncs a step (rank 0) "
        f"{t['syncs'] if on_card else None}, the fp32 cut's unsharded twin's "
        f"{res[0][twins[name]].get('ref_syncs')}; group warm-up s "
        f"{ {k: round(v, 3) for k, v in t['warm_s'].items()} }; case {t['seconds']:.1f} s "
        f"[{smi}]")
    prof = t.get("profile")
    if prof:
        log(f"[multicard] T3 full: profiled step (rank 0, the last): {prof['wall_ms']:.1f} ms "
            f"wall, {prof['busy_ms']:.1f} ms device busy over {prof['ops']} device ops, NCCL "
            f"kernels {prof['nccl_ms']:.2f} ms ({prof['nccl_ms'] / prof['wall_ms']:.1%} of the "
            f"step) [{smi}]")
    for r, x in res.items():
        t = x[name]
        m = t["dry_memory"]
        CS.memory_gate(f"[multicard] T3 full rank {r}", m["argument_size_in_bytes"],
                       m["temp_size_in_bytes"], t["peak"], t["start"], on_card, smi,
                       "launch.dryrun on RankMesh.dry, bf16 params and fp32 moments; measured "
                       "over the optimizer state's init and the bf16 steps", tol=T3_MEMORY_TOL)
        for i, tally in enumerate(t["tally"]):
            if CS.tally_counts(tally) != t["predicted"]:
                raise AssertionError(f"T3 full rank {r}: step {i}'s collectives "
                                     f"{CS.tally_counts(tally)}, predicted {t['predicted']}")
        if t["dry"] != t["predicted"] or t["bytes"] != t["dry_bytes"]:
            raise AssertionError(f"T3 full rank {r}: the dry run counts {t['dry']} and "
                                 f"{t['dry_bytes']} B, predicted {t['predicted']}, "
                                 f"{t['bytes']} B")
        losses = t["loss"]
        if not np.isfinite(losses).all() or losses[0] - losses[-1] <= (
                CS.TRAIN_FALL if on_card else 0.0):
            raise AssertionError(f"T3 full rank {r}: losses {losses}")
    if on_card:
        t_syncs_gate(res, name, twins[name])


# ------------------------------------------------- S: the live loop over groups
#: S2's workload: steady requests (routed), the burst (pinned to instance
#: 0), their lengths, and the steps of each phase
S_BASE, S_BURST, S_PROMPT, S_BASE_NEW, S_BURST_NEW = 4, 8, 12, 16, 40
S_STEADY_STEPS, S_BURST_STEPS, S_FOUR_STEPS, S_POST_STEPS = 8, 8, 4, 6
#: the weight-read bound of one llama2-13b decode step (PERF.md §5)
BOUND_13B_MS = 7.673


class _Tee:
    """Writes to every stream it holds (S1 reads what ``run`` printed)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, x):
        for st in self.streams:
            st.write(x)
        return len(x)

    def flush(self):
        for st in self.streams:
            st.flush()


def s_memory():
    """Each card's used memory as ``nvidia-smi`` reads it (MiB)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return [int(x) for x in out.split()]


def s1_part(on_card, smi):
    """S1: ``launch.serve.run`` as a user runs it (module docstring)."""
    import io

    from repro_torch.launch import serve as S
    from repro_torch.serving import group as G

    cfg = S.ServeConfig(arch="llama2-13b", reduced=not on_card, instances=2,
                        requests=24, rps=4, drain=True,
                        device="cuda" if on_card else "cpu")
    width = G.host_width
    if not on_card:   # the rehearsal: four CPU ranks an instance
        G.host_width = lambda device, count: WORLD
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(_Tee(buf, sys.stdout)):
            n = S.run(cfg)
    finally:
        G.host_width = width
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    codes = [line for line in out.splitlines() if "exited with codes" in line]
    if n != 24 or "dropped=0" not in out or "24 requests" not in out:
        raise AssertionError(f"S1: {n} of 24 finished, or dropped > 0")
    if not codes or codes[0].split("codes", 1)[1].strip() != str([[0] * WORLD] * 2):
        raise AssertionError(f"S1: server exit codes {codes}")
    if f"each a group of {WORLD} cards" not in out:
        raise AssertionError("S1: the instances do not span the cards")
    L = sizes(on_card).l13.num_layers
    steps = [ast.literal_eval(line.split("decode steps ", 1)[1].split(", paged")[0])
             for line in out.splitlines() if "by rank: decode steps" in line]
    launches = [ast.literal_eval(line.split("paged launches ", 1)[1].split(", decode graphs")[0])
                for line in out.splitlines() if "by rank: decode steps" in line]
    if len(steps) != 2 or (on_card and any(n != L * d for st, ln in zip(steps, launches)
                                           for d, n in zip(st, ln))):
        raise AssertionError(f"S1: decode steps {steps}, paged launches {launches}")
    log(f"[multicard] S1 launch.serve.run(llama2-13b, {'published width, bf16' if on_card else 'reduced'}, "
        f"2 instances x {WORLD} cards, 24 requests at rps 4, drain): 24 of 24 finished, "
        f"dropped 0, every server exited 0, paged launches = {L} x decode steps on every "
        f"rank ({[sum(x) for x in launches]} an instance), {secs:.1f} s [{smi}]")
    return {"s": secs, "launches": sum(map(sum, launches))}


def s_requests(cfg, n, rid0, max_new, seed):
    from repro_torch.serving.request import RequestSpec

    rng = np.random.default_rng(seed)
    return [RequestSpec(rid=rid0 + i, prompt=rng.integers(2, cfg.vocab_size, size=S_PROMPT)
                        .astype(np.int32), max_tokens=max_new) for i in range(n)]


def s_steps(orch, n, first, t_sub):
    """``n`` orchestrator steps; the wall time each stream's first token
    was seen (``first``) and the tokens per second over the steps."""
    toks0 = sum(t.total_tokens for t in orch.telemetry)
    t0 = time.perf_counter()
    for _ in range(n):
        fin = orch.step()
        now = time.perf_counter()
        seen = {rid for rid, toks in orch.stream_view().items() if toks} | {
            r.rid for r in fin}
        for rid in seen:
            if rid in t_sub and rid not in first:
                first[rid] = now
    return (sum(t.total_tokens for t in orch.telemetry) - toks0) / (time.perf_counter() - t0)


def s_drain(orch, src, dst, overlap):
    """Instance ``src`` emptied onto ``dst`` as ``drain_instance`` does:
    the queue handed over, then the active streams moved stop-the-world
    (``overlap`` None) or two-phase over ``overlap`` steps."""
    for req in orch.instances[src].drain_queue():
        orch._home[req.rid] = dst
        orch.instances[dst].push_queue(req)
    if overlap is None:
        return orch.migrate_requests(src, dst)
    return orch.migrate_requests_overlapped(src, dst, overlap_steps=overlap)


def one_card_flips(cfg, kw, draw, specs, streams, on_card):
    """The requests ``specs`` (rid -> spec), greedy, through one
    unreplicated server on card 0 with the same draw; for each stream of
    ``streams`` (rid -> tokens) that leaves that run's: (rid, the first
    token that differs, it, the one card's, the witness's top-2 logits
    and ids after the common prefix)."""
    from repro_torch.serving.remote_engine import EngineProxy

    dev = kw["device"]
    ref = EngineProxy(cfg, None, draw=draw, **dict(kw, device=f"{dev}:0" if on_card else dev))
    try:
        for rid in sorted(specs):
            ref.submit(specs[rid])
        done = []
        while ref.queue_len() or ref.active_rids():
            done += ref.step()
        one = {r.rid: list(r.generated) for r in done}
        flips = []
        for rid, got in streams.items():
            if got != one[rid]:
                t = next(i for i, (a, b) in enumerate(zip(got, one[rid])) if a != b)
                prefix = [int(x) for x in specs[rid].prompt] + got[:t]
                flips.append((rid, t, got[t], one[rid][t], ref._call("witness_top2", prefix)))
        return flips
    finally:
        ref.close()


def s2_part(on_card, smi):
    """S2: the §5 loop over two instances of four ranks (module
    docstring). Returns its measurements; raises where a gate fails."""
    from repro_torch.configs import get_config
    from repro_torch.core import migration as MIG
    from repro_torch.core.monitor import MetricsSnapshot
    from repro_torch.launch.serve import SERVE_MAX_LEN
    from repro_torch.serving.group import GroupInstance, start_all
    from repro_torch.serving.orchestrator import Orchestrator

    cfg = get_config("llama2-13b")
    cfg, dtype = (cfg, "bfloat16") if on_card else (cfg.reduced(), "float32")
    dev = "cuda" if on_card else "cpu"
    L = cfg.num_layers
    kw = dict(max_batch=4, max_len=SERVE_MAX_LEN, dtype=dtype, device=dev,
              scheduler="budget", token_budget=128)
    draw = {"seed": CS.SEED, "dtype": dtype}
    server = {"sync_debug": on_card, "check_paged": True}
    t0 = time.perf_counter()
    handles = start_all([lambda i=i: GroupInstance(cfg, width=WORLD, draw=draw,
                                                   label=f"s2-{i}", server=server, **kw)
                         for i in range(2)])
    out = {"bringup_s": time.perf_counter() - t0,
           "bringup": [h.bringup for h in handles],
           "mem_up": s_memory() if on_card else []}
    orch = Orchestrator(cfg, None, handles=handles, slo_latency=40.0, telemetry_every=4)
    decided = []
    on_change = orch.controller.on_plan_change

    def plan_change(plan, bs):
        decided.append((time.perf_counter(), list(plan.p)))
        on_change(plan, bs)

    orch.controller.on_plan_change = plan_change
    t_sub, first, phases = {}, {}, {}
    try:
        base = s_requests(cfg, S_BASE, 0, S_BASE_NEW, 0)
        burst = s_requests(cfg, S_BURST, 100, S_BURST_NEW, 1)
        specs = {s.rid: s for s in base + burst}
        for spec in base:
            t_sub[spec.rid] = time.perf_counter()
            orch.submit(spec)
        phases["before"] = s_steps(orch, S_STEADY_STEPS, first, t_sub)
        for spec in burst:
            t_sub[spec.rid] = time.perf_counter()
            orch.submit_to(0, spec)
        phases["during"] = s_steps(orch, S_BURST_STEPS, first, t_sub)
        scaled = [a for a in orch.controller.log if a.startswith("scale-up")]
        how = "the controller, from the servers' telemetry"
        if not scaled:
            # the card's telemetry did not trip t_up: a vacancy snapshot
            # (instance 1 idle, both pools mostly free), as phase 7 feeds a
            # violating one
            how = "the controller, fed a vacancy snapshot"
            orch.controller._cooldown = 0
            orch.controller.observe(MetricsSnapshot(
                t=orch.clock(), device_util=[1.0, 0.0], device_mem_frac=[0.3, 0.1],
                block_vacancy=[0.7, 0.9]))
            act = orch.controller.tick()
            if not (act and act.startswith("scale-up")):
                raise AssertionError(f"S2: the controller answered {act!r}")
            scaled = [act]
        t_dec, plan = decided[-1]
        orch.step()
        out["scale_up"] = {"how": how, "action": scaled[0], "plan": plan,
                           "s": time.perf_counter() - t_dec}
        for h in orch.instances:
            h.apply_plan([4] * L)
        s_steps(orch, S_FOUR_STEPS, first, t_sub)
        for _ in range(40):   # instance 1 empty, so that it takes 0's streams
            if not (orch.instances[1].queue_len() or orch.instances[1].active_rids()):
                break
            s_steps(orch, 1, first, t_sub)
        moves = {"stw": s_drain(orch, 0, 1, None)}
        s_steps(orch, 2, first, t_sub)
        moves["two-phase"] = s_drain(orch, 1, 0, 3)
        phases["after"] = s_steps(orch, S_POST_STEPS, first, t_sub)
        orch.run_until_done()
        out["mem_end"] = s_memory() if on_card else []
        infos = [h.rank_infos() for h in handles]
        out.update(
            phases=phases, moves={k: [dataclasses.asdict(m) for m in v] for k, v in moves.items()},
            ttft={rid: first[rid] - t_sub[rid] for rid in first},
            streams={r.rid: list(r.generated) for r in orch.finished},
            stats={k: v for k, v in orch.stats().items() if k in ("dropped", "finished", "migrations")},
            logs=[h.step_logs for h in handles], infos=infos,
            pool_checks=[h.pool_checks for h in handles],
            read_backs=[h.read_backs for h in handles], controller=list(orch.controller.log),
            plan=list(orch.plan.p), estimate=[[MIG.estimate_cost(m.bytes_moved, orch.link_bandwidth)
                                               for m in v] for v in moves.values()])
    finally:
        orch.close()
    out["exitcodes"] = [h.exitcodes for h in handles]
    out["flips"] = one_card_flips(cfg, kw, draw, specs, out["streams"], on_card)
    out["s"] = time.perf_counter() - t0
    return out


def s2_gates(r, on_card, smi, L):
    """S2's gates and its printed lines (module docstring)."""
    if r["stats"]["dropped"] or r["stats"]["finished"] != S_BASE + S_BURST:
        raise AssertionError(f"S2: {r['stats']}")
    if r["exitcodes"] != [[0] * WORLD] * 2:
        raise AssertionError(f"S2: server exit codes {r['exitcodes']}")
    resumed = sum(m["resumed"] for v in r["moves"].values() for m in v)
    imports = sum((1 if k == "stw" else 2) * m["resumed"] for k, v in r["moves"].items()
                  for m in v)
    if not r["moves"]["stw"] or not r["moves"]["two-phase"] or resumed < 2:
        raise AssertionError(f"S2: moves {r['moves']}")
    if sum(r["read_backs"]) < imports or min(r["pool_checks"]) < 2:
        raise AssertionError(f"S2: {r['read_backs']} imports read back of {imports}, "
                             f"pool checks {r['pool_checks']}")
    for i, (logs, infos) in enumerate(zip(r["logs"], r["infos"])):
        for k, info in enumerate(infos):
            name = f"S2 instance {i} rank {k}"
            steps = info["decode_steps"]
            if on_card and info["paged_launches"] != L * steps:
                raise AssertionError(f"{name}: {info['paged_launches']} paged launches for "
                                     f"{steps} decode steps")
            checks = info["paged_checks"]
            if len(checks) != L or max(checks) > 2e-2 or info["checked_steps"] != 1:
                raise AssertionError(f"{name}: paged calls of the checked step {checks}")
            for step in logs:
                s = step[k]
                if s["decode"] and s["degrees"] and \
                        s["gathers"] != CS.predicted_gathers(s["degrees"]):
                    raise AssertionError(f"{name}: {s['gathers']} all-gathers under "
                                         f"{s['degrees']}")
            if on_card:
                caps = info["graph_captures"].get("decode", 0)
                reps = info["graph_replays"].get("decode", 0)
                if info["graph_eager"].get("decode", 0) or caps + reps + 1 != steps or \
                        not caps <= info["decode_keys"] <= caps + 1:
                    raise AssertionError(f"{name}: captures {caps}, replays {reps}, eager "
                                         f"{info['graph_eager']}, keys {info['decode_keys']}, "
                                         f"{steps} decode steps")
                if set(info["steady_syncs"]) - {"1"}:
                    raise AssertionError(f"{name}: host syncs per steady step "
                                         f"{info['steady_syncs']}")
    for rid, t, got, one, (vals, ids) in r["flips"]:
        if not ({got, one} <= set(ids) and vals[0] - vals[1] <= BF16_TIE * max(1.0, abs(vals[0]))):
            raise AssertionError(f"S2: rid {rid} token {t}: {got} against one card's {one}, "
                                 f"top-2 {vals} {ids}")
    for i, infos in enumerate(r["infos"]):
        x = infos[0]
        log(f"[multicard] S2 instance {i} rank 0's counters (every rank's equal): "
            f"{x['decode_steps']} decode steps, {x['decode_keys']} decode keys, captures "
            f"{x['graph_captures']}, replays {x['graph_replays']}, eager {x['graph_eager']}, "
            f"1 checked step (worst paged call against its plain version "
            f"{max(x['paged_checks']):.3e}), paged launches {x['paged_launches']} = {L} x "
            f"decode steps, host syncs per replayed steady step {x['steady_syncs']} [{smi}]")
    if any(info[k] != infos[0][k] for infos in r["infos"] for info in infos
           for k in ("decode_steps", "paged_launches", "graph_captures", "graph_replays")):
        raise AssertionError("S2: the ranks of an instance counted different steps")
    sec = r["scale_up"]
    log(f"[multicard] S2 scale-up by {sec['how']}: {sec['action']}, plan {sec['plan'][:8]}... "
        f"(degree > 1 on {sum(p > 1 for p in sec['plan'])} of {L} layers), decision to the end "
        f"of the first step under it {sec['s'] * 1e3:.1f} ms (captures included) [{smi}]")
    logs0 = [step[0] for step in r["logs"][0] + r["logs"][1]]
    by = collections.defaultdict(list)
    for s in logs0:
        if s["decode"] and s["steady"] and not s["captured"] and not s["checked"]:
            by[tuple(s["degrees"]) if s["degrees"] else "degree 1"].append(s["ms"])
    for key, ms in by.items():
        name = key if key == "degree 1" else (f"[4]*{L}" if set(key) == {4} else
                                              f"{sum(d > 1 for d in key)} layers at "
                                              f"{sorted(set(key) - {1})}")
        log(f"[multicard] S2 {'graph' if on_card else 'eager'} steps at {name}: median {CS.median(ms):.3f} ms over {len(ms)} "
            f"(server clock, rank 0; weight-read bound {BOUND_13B_MS} ms) [{smi}]")
    ph, tt = r["phases"], r["ttft"]
    base = [tt[i] for i in range(S_BASE) if i in tt]
    burst = [tt[i] for i in range(100, 100 + S_BURST) if i in tt]
    log(f"[multicard] S2 tok/s before / during / after the burst {ph['before']:.1f} / "
        f"{ph['during']:.1f} / {ph['after']:.1f}; TTFT median ms steady "
        f"{CS.median(base) * 1e3:.1f}, burst {CS.median(burst) * 1e3:.1f} [{smi}]")
    for (kind, ms), est in zip(r["moves"].items(), r["estimate"]):
        log(f"[multicard] S2 {kind} moves: " + "; ".join(
            f"rid {m['rid']} {m['src']}->{m['dst']} {m['bytes_moved']} B in "
            f"{m['seconds'] * 1e3:.1f} ms (stall {m['stall_s'] * 1e3:.1f} ms, estimate_cost "
            f"{e * 1e3:.1f} ms, resumed {m['resumed']})" for m, e in zip(ms, est)) + f" [{smi}]")
    for i, b in enumerate(r["bringup"]):
        log(f"[multicard] S2 instance {i} bring-up s (spawn+connect, group, draw, broadcast, "
            f"ready) by rank: " + "; ".join(
                f"{x['connect_s']:.1f}, {x['group_s']:.2f}, {x['draw_s']:.2f}, "
                f"{x['broadcast_s']:.3f}, {x['ready_s']:.1f}" for x in b) + f" [{smi}]")
    peaks = [[info["peak_bytes"] / 1e9 for info in infos] for infos in r["infos"]]
    log(f"[multicard] S2 peak GB a server (instance x rank) {[[round(p, 2) for p in x] for x in peaks]}; "
        f"a card (two servers) {[round(a + b, 2) for a, b in zip(*peaks)]}; nvidia-smi MiB used "
        f"after bring-up {r['mem_up']}, at the end {r['mem_end']} [{smi}]")
    log(f"[multicard] S2: {S_BASE + S_BURST} finished, dropped 0, every server exited 0; tokens "
        f"equal on every rank at every step, pools bit-equal after {r['pool_checks']} plan and "
        f"move checks, {sum(r['read_backs'])} imports read back bit-equal on every rank; flips "
        f"against one card (rid, token, top-2 gap over the top logit) "
        f"{[(f[0], f[1], round((f[4][0][0] - f[4][0][1]) / abs(f[4][0][0]), 5)) for f in r['flips']]} "
        f"of {len(r['streams'])} streams; controller {r['controller']}; "
        f"final plan {r['plan'][:8]}...; {r['s']:.1f} s [{smi}]")


def s_part(on_card, smi):
    """Part S in this process (module docstring)."""
    res = {}
    for name, part in (("S1", lambda: s1_part(on_card, smi)),
                       ("S2", lambda: s2_part(on_card, smi))):
        t0 = time.perf_counter()
        res[name] = part()
        res[f"{name} s"] = time.perf_counter() - t0
    return res


# --------------------------------------------------------------------- part E
#: E1: the orchestrator step (from the workload's start) at which every
#: instance takes [4]*40, and the first step at which rank 2 of w1 is killed
#: inside a step (the first one from there at which w1 decodes)
E1_PLAN_AT, E1_KILL_AT = 4, 10
#: E2: the completions the client posts, how many at once, their new tokens
#: (10 at once keep more than 4 queued on one instance of 4 rows: the grow;
#: 8 tokens keep each request's engine-clock latency under the 40-step SLO,
#: whose violations would press for a grow again after the shrink)
E2_REQUESTS, E2_CLIENTS, E2_NEW = 24, 10, 8
#: the card memory gates' slack (MiB, by nvidia-smi)
E_MEMORY_SLACK = 2048
#: a server's options in part E: its first steady replicated step checked
E_SERVER = {"check_paged": True}


@contextlib.contextmanager
def host_cards(on_card):
    """``launch.serve``'s width rule as the card sees it; the rehearsal
    forces four CPU ranks an instance."""
    from repro_torch.serving import group as G

    width = G.host_width
    if not on_card:
        G.host_width = lambda device, count: WORLD
    try:
        yield
    finally:
        G.host_width = width


def e_args(on_card, **kw):
    from repro_torch.launch import serve as S

    return S.ServeConfig(arch="llama2-13b", reduced=not on_card, max_batch=4,
                         device="cuda" if on_card else "cpu", **kw)


def e_checked(infos, L, name):
    """Every rank of a group ran one checked step: each of its ``L``
    paged calls within 2e-2 of the plain version."""
    for k, x in enumerate(infos):
        c = x["paged_checks"]
        if x["checked_steps"] != 1 or len(c) != L or max(c) > 2e-2:
            raise AssertionError(f"{name} rank {k}: checked steps {x['checked_steps']}, "
                                 f"paged calls against the plain version {c}")
    return max(max(x["paged_checks"]) for x in infos)


def e1_part(on_card, smi, s_mem):
    """E1: ``--workers 2 --supervise --drain`` (module docstring)."""
    from repro_torch.launch import serve as S

    args = e_args(on_card, workers=2, supervise=True, drain=True, requests=24, rps=4)
    t0 = time.perf_counter()
    with host_cards(on_card):
        plane = S.build_plane(args, server=E_SERVER)
    orch, L = plane.orch, plane.cfg.num_layers
    out = {"bringup_s": time.perf_counter() - t0, "mem_up": s_memory() if on_card else []}
    ev = {"walls": []}

    def kill_inside_the_step(h):
        send, fail = h.step_async, h._fail

        def step_async():   # the step is out to every rank: SIGKILL rank 2
            w = send()
            h.step_async = send
            ev["t_kill"] = time.monotonic()
            h.ranks[2].kill()
            return w

        def _fail(reason):
            ev.setdefault("t_fail", time.monotonic())
            ev.setdefault("reason", reason)
            fail(reason)

        h.step_async, h._fail = step_async, _fail

    def hook(o, step):
        now = time.monotonic()
        if "t_last" in ev:
            ev["walls"].append((now - ev["t_last"], o.faults.respawns))
        ev["t_last"] = now
        if step == E1_PLAN_AT:
            o._on_plan_change(types.SimpleNamespace(p=[WORLD] * L), args.max_batch)
        w1 = o.instances[1]
        if step >= E1_KILL_AT and "armed" not in ev and w1.alive() and w1.active_rids():
            ev["armed"] = step
            out["mem_before_kill"] = s_memory() if on_card else []
            out["killed_rids"] = sorted(w1.active_rids().values())
            kill_inside_the_step(w1)
        if o.faults.respawns and "mem_respawned" not in ev:
            ev["mem_respawned"] = s_memory() if on_card else []

    try:
        S.serve_workload(args, plane, hook=hook)
        fresh = orch.instances[1]
        # re-admitted: a replicated plan, and a request pinned to w1~r1
        orch._on_plan_change(types.SimpleNamespace(p=[WORLD] * L), args.max_batch)
        pin = s_requests(plane.cfg, 1, 500, 8, 2)[0]
        orch.submit_to(1, pin)
        orch.run_until_done()
        sums = [h._all("params_checksum") for h in orch.instances]
        out.update(
            finished=len(orch.finished), stats={k: v for k, v in orch.stats().items()
                                                if k in ("dropped", "finished", "recoveries")},
            recoveries=[{k: r[k] for k in ("instance", "reason", "detect_s", "rids")}
                        for r in orch.recoveries],
            respawn_log=list(orch.respawn_log), labels=[h.label for h in orch.instances],
            rank_labels=[r.peer_label for r in fresh.ranks],
            sums_equal=all(x == sums[0][0] for h in sums for x in h),
            pinned_home=orch._home.get(pin.rid),
            pinned=next(list(r.generated) for r in orch.finished if r.rid == pin.rid),
            infos=fresh.rank_infos(), w0_infos=orch.instances[0].rank_infos(),
            streams={r.rid: list(r.generated) for r in orch.finished},
            mem_respawned=ev.get("mem_respawned", []), walls=ev["walls"],
            detect_s=ev["t_fail"] - ev["t_kill"], reason=ev["reason"], armed=ev["armed"])
    finally:
        S._close(orch)
    out["exitcodes"] = [h.exitcodes for h in orch.instances]
    # the replayed streams against one undisturbed, unreplicated card
    make = S._requests(args, plane.cfg)
    specs = {r.rid: r for r in (make(i) for i in range(args.requests))}
    replayed = {rid for rec in out["recoveries"] for rid in rec["rids"]}
    kw = dict(max_batch=args.max_batch, max_len=S.SERVE_MAX_LEN, dtype=plane.dtype,
              device=args.device, scheduler=args.scheduler, token_budget=args.token_budget)
    out["flips"] = one_card_flips(plane.cfg, kw, {"seed": 0, "dtype": plane.dtype},
                                  {rid: specs[rid] for rid in replayed},
                                  {rid: out["streams"][rid] for rid in replayed}, on_card)
    out["replayed"] = sorted(replayed)
    out["s_mem"] = s_mem
    out["s"] = time.perf_counter() - t0
    return out


def e1_gates(r, on_card, smi, L):
    """E1's gates and lines (module docstring)."""
    if r["stats"]["dropped"] or r["finished"] != 25:
        raise AssertionError(f"E1: {r['finished']} of 24 + 1 finished, {r['stats']}")
    if r["detect_s"] >= 5.0 or "rank 2 closed in step" not in r["reason"]:
        raise AssertionError(f"E1: w1 failed {r['detect_s']:.3f} s after the kill: {r['reason']}")
    rec = r["recoveries"]
    if [x["instance"] for x in rec] != [1] or not set(r["killed_rids"]) <= set(rec[0]["rids"]):
        raise AssertionError(f"E1: recoveries {rec}, killed inside the step {r['killed_rids']}")
    spawned = [e for e in r["respawn_log"] if e["event"] == "respawned"]
    if r["labels"] != ["w0", "w1~r1"] or [e["label"] for e in spawned] != ["w1~r1"] or \
            r["rank_labels"] != [f"w1~r1/r{k}" for k in range(WORLD)]:
        raise AssertionError(f"E1: labels {r['labels']}, {r['rank_labels']}, {r['respawn_log']}")
    if on_card and [x["device"] for x in r["infos"]] != [f"cuda:{k}" for k in range(WORLD)]:
        raise AssertionError(f"E1: w1~r1 on {[x['device'] for x in r['infos']]}")
    if not r["sums_equal"]:
        raise AssertionError("E1: the weights differ between the ranks of w0 and w1~r1")
    if r["pinned_home"] != 1:
        raise AssertionError(f"E1: the pinned request finished on instance {r['pinned_home']}")
    worst = e_checked(r["infos"], L, "E1 w1~r1")
    if on_card:
        for name, infos in (("w0", r["w0_infos"]), ("w1~r1", r["infos"])):
            if any(x["paged_launches"] != L * x["decode_steps"] for x in infos):
                raise AssertionError(f"E1 {name}: paged launches {[x['paged_launches'] for x in infos]}"
                                     f" for decode steps {[x['decode_steps'] for x in infos]}")
        ref = r["s_mem"] or r["mem_before_kill"]
        if any(a > b + E_MEMORY_SLACK for a, b in zip(r["mem_respawned"], ref)):
            raise AssertionError(f"E1: MiB used after the respawn {r['mem_respawned']}, two "
                                 f"instances {ref}")
    if r["exitcodes"] != [[0] * WORLD] * 2:
        raise AssertionError(f"E1: server exit codes {r['exitcodes']}")
    stall = next(w for w, n in r["walls"] if n)   # the step that brought w1~r1 up
    down = spawned[0]["downtime_s"]
    log(f"[multicard] E1 launch.serve --workers 2 --supervise --drain (llama2-13b, "
        f"{'published width, bf16' if on_card else 'reduced'}, 2 instances x {WORLD} cards, "
        f"24 requests at rps 4): rank 2 of w1 SIGKILLed inside step {r['armed']} under "
        f"[{WORLD}]*{L}; w1 failed {r['detect_s'] * 1e3:.1f} ms after the kill (no RPC deadline; "
        f"orchestrator's detect_s {rec[0]['detect_s'] * 1e3:.1f} ms), its streams {rec[0]['rids']} "
        f"replayed on w0; w1~r1 up on the same cards after {down:.1f} s of downtime, the serving "
        f"loop stalled {stall:.1f} s in the step that brought it up; 24 + 1 pinned finished, "
        f"dropped 0; w1~r1's weights equal on its ranks and to w0's; the pinned request finished "
        f"on w1~r1, its checked step's worst paged call {worst:.3e} from the plain version; every "
        f"server exited 0 [{smi}]")
    log(f"[multicard] E1 nvidia-smi MiB used: after bring-up {r['mem_up']}, before the kill "
        f"{r['mem_before_kill']}, after the respawn {r['mem_respawned']}; part S's two instances "
        f"{r['s_mem'] or 'not run'} [{smi}]")
    log(f"[multicard] E1 replayed streams {r['replayed']} against one undisturbed card: flips "
        f"(rid, token, top-2 gap over the top logit) "
        f"{[(f[0], f[1], round((f[4][0][0] - f[4][0][1]) / abs(f[4][0][0]), 5)) for f in r['flips']]}"
        f" [{smi}]")


def e2_part(on_card, smi):
    """E2: ``--http --elastic``, one instance at start, ``--max-pod 2``
    (module docstring)."""
    import _thread
    import threading
    import urllib.request

    from repro_torch.launch import serve as S

    # ten at once reach one instance before it admits any: an admission
    # ceiling above them, so that none is shed with a 429
    args = e_args(on_card, http=True, elastic=True, instances=1, max_pod=2, http_port=0,
                  requests=0, max_queue=2 * E2_CLIENTS)
    t0 = time.perf_counter()
    with host_cards(on_card):
        plane = S.build_plane(args, server=E_SERVER)
    orch, L = plane.orch, plane.cfg.num_layers
    out = {"bringup_s": time.perf_counter() - t0, "statuses": [], "tokens": [], "routed": []}
    factory = orch.worker_factory

    def grow(idx):
        """The grouped factory, and one checked replicated step of a probe
        request on the fresh group before the pod admits it."""
        out["mem_one"] = s_memory() if on_card else []
        t = time.perf_counter()
        h = factory(idx)
        out["grow_s"] = time.perf_counter() - t
        out["grown_bringup"] = h.bringup
        h.apply_plan([WORLD] * L)
        h.submit(s_requests(plane.cfg, 1, 900 + idx, 8, 3)[0])
        while h.queue_len() or h.active_rids():
            h.step()
        h.apply_plan([1] * L)
        out["grown_infos"] = h.rank_infos()
        return h

    orch.worker_factory = grow
    prompts = s_requests(plane.cfg, E2_REQUESTS, 0, E2_NEW, 4)

    def client():
        try:
            while plane.ingress is None:
                time.sleep(0.05)
            url = f"http://127.0.0.1:{plane.ingress.port}/v1/completions"
            left = list(prompts)
            lock = threading.Lock()

            def worker():
                while True:
                    with lock:
                        if not left:
                            return
                        spec = left.pop(0)
                    body = json.dumps({"prompt": [int(x) for x in spec.prompt],
                                       "max_tokens": E2_NEW}).encode()
                    req = urllib.request.Request(url, data=body,
                                                 headers={"Content-Type": "application/json"})
                    try:
                        with urllib.request.urlopen(req, timeout=600) as resp:
                            body = json.loads(resp.read())
                            out["statuses"].append(resp.status)
                            out["tokens"].append(len(body["tokens"]))
                            out["routed"].append(body["routing"]["instance"])
                    except urllib.error.HTTPError as e:
                        out["statuses"].append(e.code)

            ws = [threading.Thread(target=worker) for _ in range(E2_CLIENTS)]
            for w in ws:
                w.start()
            for w in ws:
                w.join()
            out["traffic_s"] = time.perf_counter() - t0
            deadline = time.monotonic() + 180
            while not any(e["event"] == "shrink" for e in orch.pod_log) and \
                    time.monotonic() < deadline:
                time.sleep(0.2)
            time.sleep(2.0)   # the retired servers' memory freed by the CUDA driver
            out["mem_shrunk"] = s_memory() if on_card else []
        except BaseException as e:  # noqa: BLE001 - gated below
            out["client_error"] = repr(e)
        finally:
            _thread.interrupt_main()   # the Ctrl-C serve_http waits for

    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        S.serve_http(args, plane)
    except KeyboardInterrupt:
        pass
    th.join()
    out.update(pod_log=list(orch.pod_log), finished=len(orch.finished),
               dropped=orch.dropped, retired=sorted(orch._retired),
               controller=[a for a in orch.controller.log if "pod" in a])
    S._close(orch)
    out["exitcodes"] = [h.exitcodes for h in orch.instances]
    out["s"] = time.perf_counter() - t0
    return out


def e2_gates(r, on_card, smi, L):
    """E2's gates and lines (module docstring)."""
    if "client_error" in r:
        raise AssertionError(f"E2: the client failed: {r['client_error']}")
    if [e["event"] for e in r["pod_log"]] != ["grow", "shrink"]:
        raise AssertionError(f"E2: pod log {r['pod_log']}")
    if r["statuses"] != [200] * E2_REQUESTS or r["tokens"] != [E2_NEW] * E2_REQUESTS or \
            r["finished"] != E2_REQUESTS or r["dropped"]:
        raise AssertionError(f"E2: statuses {r['statuses']}, tokens {r['tokens']}, "
                             f"{r['finished']} finished, dropped {r['dropped']}")
    if len(r["retired"]) != 1 or r["exitcodes"] != [[0] * WORLD] * 2:
        raise AssertionError(f"E2: retired {r['retired']}, server exit codes "
                             f"{r['exitcodes']} (the retired group's closed within 60 s)")
    worst = e_checked(r["grown_infos"], L, "E2 g1")
    if on_card and any(abs(a - b) > E_MEMORY_SLACK for a, b in zip(r["mem_shrunk"], r["mem_one"])):
        raise AssertionError(f"E2: MiB used after the shrink {r['mem_shrunk']}, one instance "
                             f"{r['mem_one']}")
    b = r["grown_bringup"]
    log(f"[multicard] E2 launch.serve --http --elastic --max-pod 2 (llama2-13b, "
        f"{'published width, bf16' if on_card else 'reduced'}, 1 instance of {WORLD} cards at "
        f"start): {E2_REQUESTS} completions from {E2_CLIENTS} clients, all 200 with {E2_NEW} "
        f"tokens, {r['routed'].count(1)} routed to g1; the controller {r['controller']}; pod log {r['pod_log']}; the grow (g1's "
        f"bring-up, the loop stalled in it) {r['grow_s']:.1f} s, by rank spawn "
        f"{[round(x['connect_s'], 1) for x in b]} s, group {[round(x['group_s'], 2) for x in b]} s, "
        f"the new communicator's first collective {[round(x['first_collective_s'] * 1e3, 1) for x in b]}"
        f" ms; g1's checked step's worst paged call {worst:.3e} from the plain version; instance "
        f"{r['retired'][0]} retired, every server exited 0; nvidia-smi MiB used: one instance "
        f"{r['mem_one']}, after the shrink {r['mem_shrunk']}; {r['s']:.1f} s [{smi}]")


def e3_part(on_card, smi, out_dir):
    """E3: ``--inventory`` of one spawn node, capacity 2 (module
    docstring)."""
    import io

    from repro_torch.launch import serve as S
    from repro_torch.serving import transport as TR

    for _ in range(50):   # eight consecutive free ports
        base = int(TR.free_tcp_endpoint().rsplit(":", 1)[1])
        if base + 2 * WORLD < 65536 and all(port_free(base + k) for k in range(2 * WORLD)):
            break
    path = Path(out_dir) / "e3_pod.toml"
    path.write_text(f'[[node]]\nhost = "127.0.0.1"\nport = {base}\ncapacity = 2\n'
                    'spawn = true\n')
    args = e_args(on_card, inventory=str(path), drain=True, requests=12, rps=4)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with host_cards(on_card), contextlib.redirect_stdout(_Tee(buf, sys.stdout)):
        plane = S.build_plane(args)
        eps = [[r.endpoint for r in h.ranks] for h in plane.orch.instances]
        try:
            S.serve_workload(args, plane)
            stats = plane.orch.stats()
        finally:
            S._close(plane.orch)
    return {"n": len(plane.orch.finished), "dropped": stats["dropped"], "eps": eps, "base": base,
            "exitcodes": [h.exitcodes for h in plane.orch.instances],
            "pod_line": [x for x in buf.getvalue().splitlines() if "[serve] pod:" in x],
            "s": time.perf_counter() - t0}


def port_free(port):
    import socket

    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False
    finally:
        s.close()


def e3_gates(r, on_card, smi):
    """E3's gates and line (module docstring)."""
    want = [[f"tcp://127.0.0.1:{r['base'] + WORLD * i + k}" for k in range(WORLD)]
            for i in range(2)]
    if r["n"] != 12 or r["dropped"] or r["eps"] != want or \
            r["exitcodes"] != [[0] * WORLD] * 2:
        raise AssertionError(f"E3: {r['n']} of 12 finished, dropped {r['dropped']}, endpoints "
                             f"{r['eps']}, exit codes {r['exitcodes']}")
    log(f"[multicard] E3 launch.serve --inventory (one spawn node on 127.0.0.1, capacity 2): "
        f"{r['pod_line']}, endpoints {r['eps'][0][0]}..{r['eps'][1][-1]}, 12 of 12 finished with "
        f"a drain, dropped 0, every server exited 0, {r['s']:.1f} s [{smi}]")


def e_part(on_card, smi, out_dir, s_mem):
    """Part E in this process (module docstring)."""
    res = {}
    for name, part in (("E1", lambda: e1_part(on_card, smi, s_mem)),
                       ("E2", lambda: e2_part(on_card, smi)),
                       ("E3", lambda: e3_part(on_card, smi, out_dir))):
        t0 = time.perf_counter()
        res[name] = part()
        res[f"{name} s"] = time.perf_counter() - t0
    return res


def e_gates(res, on_card, smi, L):
    e1_gates(res["E1"], on_card, smi, L)
    e2_gates(res["E2"], on_card, smi, L)
    e3_gates(res["E3"], on_card, smi)


# ------------------------------------------------------------------- the ranks
def rank_main(rank, port, parts, on_card, out_dir, results):
    """One rank process: its card, the store, the parts in order; puts
    (rank, {part: measurements}) or (rank, {"error": traceback})."""
    try:
        import torch.distributed as dist

        from repro_torch.kernels import paged_decode as PD
        from repro_torch.models import transformer as T

        device = torch.device("cuda", rank) if on_card else torch.device("cpu")
        if on_card:
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        store = dist.TCPStore("127.0.0.1", port, WORLD, is_master=rank == 0,
                              timeout=TIMEOUT)
        sz = sizes(on_card)
        c = types.SimpleNamespace(rank=rank, device=device, store=store, sz=sz, T=T, PD=PD,
                                  out_dir=out_dir, smi="", quad=None)
        c.work = types.SimpleNamespace(prompts=CS.workload(sz.c13)[0],
                                       sampled=CS.workload(sz.c13)[1])
        res = {}
        for part in parts:
            t0 = time.perf_counter()
            # part T trains: the others run no backward
            with contextlib.nullcontext() if part == "T" else torch.no_grad():
                if part == "K":
                    res[part] = kernel_part(c) if on_card else {}
                elif part == "M1":
                    res[part] = m1_part(c)
                elif part in ("M2", "M3"):
                    if c.quad is None and part == "M3":
                        from repro_torch.core import replication as R
                        c.quad = R.ReplicationGroup.build(
                            dist.PrefixStore("m3", store), rank, WORLD, device, TIMEOUT)
                    res[part] = (m2_part if part == "M2" else m3_part)(c)
                elif part == "M4":
                    res[part] = m4_part(c)
                elif part == "T":
                    res[part] = t_part(c)
            res[f"{part} s"] = time.perf_counter() - t0
            free(device)
        results.put((rank, res))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="K,M1,M2,M3,M4,T,S,E")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on four CPU processes over gloo at reduced sizes")
    args = ap.parse_args(argv)
    on_card = not args.cpu
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < WORLD):
        print(f"chip_multicard: needs {WORLD} CUDA devices, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    parts = [p for p in args.parts.split(",") if p]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    smi = "cpu rehearsal"
    if on_card:
        lines, topo = cards_smi()
        for i, line in enumerate(lines):
            log(f"[card] {i}: {line}")
        log(f"[card] nvidia-smi topo -m:\n{topo}")
        smi = lines[0]
        log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} nccl "
            f"{torch.cuda.nccl.version()}")
        from repro_torch.kernels import build

        t = time.perf_counter()
        build.build_all()
        log(f"[build] the kernels in {time.perf_counter() - t:.2f} s")
    if not on_card:   # CPU processes of the rehearsal: one thread each
        os.environ["OMP_NUM_THREADS"] = "1"
    ranked = [p for p in parts if p not in ("S", "E")]
    by = run_ranks(ranked, on_card, out_dir) if ranked else {}
    sz = sizes(on_card)
    summary = {}
    if "K" in by and on_card:
        for what, k in by["K"][0].items():
            each = [by["K"][r][what] for r in sorted(by["K"])]
            log(f"[kernel] paged_decode at {what}: max_abs_err against the plain "
                f"version on cards 0-3 {[float(f'{e['max_abs_err']:.2e}') for e in each]}; "
                f"card 0: kernel {k['ms']:.5f} ms, plain {k['plain_ms']:.5f} ms, bound "
                f"{k['bound_ms']:.5f} ms ({k['bound_by']}), {k['bound_ms'] / k['ms']:.1%} "
                f"of bound [{smi}]")
        summary["paged_decode"] = by["K"][0]
    gates = {"M1": lambda: m1_gates(by["M1"], on_card, smi),
             "M2": lambda: m2_gates(by["M2"], on_card, smi, sz.c13.num_layers),
             "M3": lambda: m3_gates(by["M3"], on_card, smi),
             "M4": lambda: m4_gates(by["M4"], on_card, smi, sz.c70.num_layers),
             "T": lambda: t_gates(by["T"], on_card, smi, sz),
             "S": lambda: s2_gates(by["S"]["S2"], on_card, smi, sz.l13.num_layers),
             "E": lambda: e_gates(by["E"], on_card, smi, sz.l13.num_layers)}
    if "S" in parts:   # in this process, once the rank processes are gone
        t0 = time.perf_counter()
        by["S"] = s_part(on_card, smi)
        log(f"[multicard] part S in {time.perf_counter() - t0:.1f} s (S1 {by['S']['S1 s']:.1f}, "
            f"S2 {by['S']['S2 s']:.1f})")
    if "E" in parts:   # after S, once its servers have gone
        t0 = time.perf_counter()
        s_mem = by["S"]["S2"]["mem_end"] if "S" in by else []
        by["E"] = e_part(on_card, smi, out_dir, s_mem)
        log(f"[multicard] part E in {time.perf_counter() - t0:.1f} s (E1 {by['E']['E1 s']:.1f}, "
            f"E2 {by['E']['E2 s']:.1f}, E3 {by['E']['E3 s']:.1f})")
    failed = []
    for part, gate in gates.items():   # every part gated, then the failures
        if part in by:
            try:
                gate()
            except AssertionError as e:
                log(f"[multicard] {part} FAILED: {e}")
                failed.append(part)
    if failed:
        raise AssertionError(f"parts {failed} failed their gates")
    print(json.dumps({"multicard": summary}))
    print(json.dumps({"ok": True, "parts": parts, "device": {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": torch.cuda.device_count() if on_card else WORLD}}))
    return 0


def run_ranks(parts, on_card, out_dir):
    """The rank parts: one spawned process a card, each running ``parts``
    in order; returns {part: {rank: measurements}}."""
    import multiprocessing as mp

    from repro_torch.serving import transport as TR

    port = int(TR.free_tcp_endpoint().rsplit(":", 1)[1])
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, port, parts, on_card, out_dir, results))
             for r in range(WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + 1100
        while len(got) < WORLD:
            try:
                rank, res = results.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"a rank failed (exit codes "
                                         f"{[p.exitcode for p in procs]})")
                continue
            if "error" in res:
                raise AssertionError(f"rank {rank} failed:\n{res['error']}")
            got[rank] = res
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if [p.exitcode for p in procs] != [0] * WORLD:
        raise AssertionError(f"rank exit codes {[p.exitcode for p in procs]}")
    log(f"[multicard] {WORLD} ranks ran {parts} in {time.perf_counter() - t0:.1f} s; by part "
        f"(rank 0): { {k: round(v, 1) for k, v in got[0].items() if k.endswith(' s')} }")
    return {part: {r: got[r][part] for r in got} for part in parts}


if __name__ == "__main__":
    sys.exit(main())
