"""Module migration demo on the PyTorch port (§3.1/§3.3): move a layer's
attention projections and then the KV cache to a replicated placement
across a group of ranks and measure the cost -- the fine-grained
operation CoCoServe's scale-down Phase 1 performs. The port's
counterpart of ``examples/migrate_modules.py``, with the same lines.

    PYTHONPATH=src python examples/torch_migrate_modules.py --device cpu
    PYTHONPATH=src python examples/torch_migrate_modules.py   # 2+ cards

Rank 0 draws the reduced tinyllama config's weights and dense cache; the
other ranks hold placeholders. ``core.migration.migrate_by_path`` and
``migrate_kv_cache`` re-place them over a ``core.replication.
ReplicationGroup``. On the CPU the ranks are threads of this process
(gloo; the reference forces 8 host devices), 8 by default. On the card
each rank is a process on a card of its own (NCCL), as many as the
host's cards allow (the largest power of two, at least 2).
"""
import argparse
import datetime
import itertools
import os
import threading

# the thread ranks share this process's MKL: its reproducible mode, set
# before the first GEMM, keeps their GEMMs bit-equal (ROADMAP C8)
os.environ.setdefault("MKL_CBWR", "COMPATIBLE")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import migration as M  # noqa: E402
from repro_torch.core.replication import ReplicationGroup  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=120)
_STORE = dist.HashStore()          # the thread ranks' store
_PREFIX = itertools.count()


def migrate(group):
    """Both moves on this rank; the lines rank 0 prints."""
    cfg = get_config("tinyllama-1.1b").reduced()
    dev = group.device
    if group.rank == 0:
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               "float32")
    else:
        params = T.init_params_meta(cfg, "float32")
    cache = T.init_cache(cfg, 2, 64, "float32", dev)
    where = f"{group.size} ranks on {dev.type}"
    # a group's first all-to-all sets its links up (seconds over NCCL):
    # one of a float a rank first, so that the moves time the moves
    one = torch.zeros(group.size, device=dev)
    group.all_to_all(torch.empty_like(one), one, [1] * group.size,
                     [1] * group.size)
    lines = ["== migrate attention projections (compute-intensive module) =="]
    params, cost = M.migrate_by_path(params, r"layers/attn", (), group,
                                     measure=True)
    lines.append(f"moved {cost.bytes_moved/1e6:.1f} MB, est "
                 f"{cost.est_seconds:.3f}s (link model), measured "
                 f"{cost.measured_seconds*1e3:.1f} ms ({where})")
    lines.append("== migrate the KV cache (memory-intensive module) ==")
    cache, cost = M.migrate_kv_cache(cache, (), group, measure=True)
    lines.append(f"moved {cost.bytes_moved/1e6:.1f} MB, est "
                 f"{cost.est_seconds:.3f}s, measured "
                 f"{cost.measured_seconds*1e3:.1f} ms ({where})")
    return lines


def thread_ranks(world):
    """``migrate`` on ``world`` thread ranks over gloo (the CPU); rank
    0's lines."""
    prefix = f"m{next(_PREFIX)}"
    out, errors = [None] * world, []
    n = torch.get_num_threads()

    def rank(r):
        try:
            torch.set_num_threads(n)
            pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, _STORE), r,
                                       world, TIMEOUT)
            out[r] = migrate(ReplicationGroup.of(pg, torch.device("cpu")))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT.total_seconds())
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a rank hung")
    if errors:
        raise errors[0]
    return out[0]


def _card_rank(rank, world, port, results):
    torch.cuda.set_device(rank)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                          timeout=TIMEOUT)
    device = torch.device("cuda", rank)
    group = ReplicationGroup.build(store, rank, world, device, TIMEOUT)
    lines = migrate(group)
    torch.cuda.synchronize(device)
    results.put((rank, lines))


def card_ranks(world):
    """``migrate`` on ``world`` processes, one a card, over NCCL; rank
    0's lines. The store lives in this process."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          timeout=TIMEOUT, wait_for_workers=False)
    results = ctx.Queue()
    procs = [ctx.Process(target=_card_rank,
                         args=(r, world, store.port, results))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=TIMEOUT.total_seconds())
                   for _ in range(world))
    finally:
        for p in procs:
            p.join(TIMEOUT.total_seconds())
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank processes exited with {codes}")
    return got[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="group size, a power of two (default: 8 on the "
                         "CPU, the host's cards on cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu")
        cards = torch.cuda.device_count()
        world = args.ranks or 1 << (cards.bit_length() - 1)
        if world < 2 or world > cards:
            raise RuntimeError(f"a group of {world} ranks needs as many "
                               f"cards, one a rank; this host has {cards}")
        lines = card_ranks(world)
    else:
        lines = thread_ranks(args.ranks or 8)
    for line in lines:
        print(line)
    print("(paper Table 2: 0.25-0.9 s per 1-40 layers at A100/NVLink scale)")
    return lines


if __name__ == "__main__":
    main()
