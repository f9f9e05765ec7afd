"""Prefix sharing demo on the PyTorch port: N chat streams over ONE system
prompt. The port's counterpart of ``examples/shared_prefix.py``, with the
same banner lines.

Runs the same shared-system-prompt workload twice through the paged
engine -- prefix sharing OFF, then ON -- and prints, for each: peak pool
blocks in use, prefix-cache hit rate, copy-on-write forks, and tok/s.
With sharing ON the first admission prefills the system prompt once;
every later stream aliases those blocks (refcounted, copy-on-write) and
prefills only its own user suffix. Outputs are token-identical either
way: sharing changes where KV lives, not what the model computes.

    PYTHONPATH=src python examples/torch_shared_prefix.py --device cpu \\
        [--streams 6] [--sys-len 32] [--max-new 8]

The reduced config in fp32, on ``--device`` (``cuda`` by default).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestSpec


def make_requests(cfg, n_streams, sys_len, user_len, max_new, seed=0):
    rng = np.random.default_rng(seed)
    system_prompt = rng.integers(2, cfg.vocab_size,
                                 size=sys_len).astype(np.int32)
    reqs = []
    for i in range(n_streams):
        user = rng.integers(2, cfg.vocab_size, size=user_len).astype(np.int32)
        reqs.append(RequestSpec(rid=i,
                                prompt=np.concatenate([system_prompt, user]),
                                max_tokens=max_new))
    return reqs


def run_once(cfg, params, args, share):
    eng = Engine(cfg, params, max_batch=args.max_batch, max_len=128,
                 cache_kind="paged", block_size=args.block_size,
                 prefix_sharing=share, device=args.device)
    for r in make_requests(cfg, args.streams, args.sys_len, args.user_len,
                           args.max_new):
        eng.submit(r)
    peak, done = 0, []
    t0 = time.perf_counter()
    while eng.queue or eng.active:
        done += eng.step() or []
        peak = max(peak, eng.pstate.blocks_in_use())
    wall = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    stats = eng.prefix_stats()
    label = "ON " if share else "OFF"
    print(f"[sharing {label}] peak blocks in use: {peak:3d} "
          f"(pool {eng.pstate.n_blocks})  hit rate: "
          f"{stats['hit_rate']:.2f}  CoW forks: {stats['cow_forks']}  "
          f"tok/s: {toks / wall:.1f}")
    return {r.rid: r.generated for r in done}, peak


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--streams", type=int, default=6)
    ap.add_argument("--sys-len", type=int, default=32,
                    help="shared system-prompt tokens")
    ap.add_argument("--user-len", type=int, default=6,
                    help="private per-stream suffix tokens")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")

    cfg = get_config(args.arch).reduced()
    params = T.init_params(
        cfg, torch.Generator(device=args.device).manual_seed(0), "float32")
    print(f"{args.streams} streams sharing a {args.sys_len}-token system "
          f"prompt (+{args.user_len} private tokens each, "
          f"block_size={args.block_size}, device={args.device})")

    off, peak_off = run_once(cfg, params, args, share=False)
    on, peak_on = run_once(cfg, params, args, share=True)

    if on != off:
        raise AssertionError("sharing must not change token streams")
    print(f"token-identical: True   peak blocks {peak_off} -> {peak_on} "
          f"({peak_off - peak_on} saved, "
          f"{100 * (1 - peak_on / max(peak_off, 1)):.0f}% less)")
    return peak_off - peak_on


if __name__ == "__main__":
    main()
