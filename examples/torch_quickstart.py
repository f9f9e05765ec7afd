"""Quickstart on the PyTorch port: build a model, prefill + decode a few
tokens, serve a small batch through the paged continuous-batching engine,
then plan a CoCoServe module operation (layer replication) and show the
modeled speedup. The port's counterpart of ``examples/quickstart.py``,
with the same banner lines.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --no-reduced  # card

On the card (the default ``--device cuda``) the engine runs its steps
as CUDA graphs through the hand-written kernels. ``--no-reduced`` runs
the config at its published widths in bf16, as ``launch.serve`` does;
the default is the reduced config in fp32.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.cluster import Cluster, layer_weight_bytes
from repro_torch.core.plan import PlacementPlan
from repro_torch.core.scale_up import scale_up
from repro_torch.core.speedup import speedup_homo
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list_archs())
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced config in fp32 (default), or with "
                         "--no-reduced its published widths in bf16")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")

    # 1) model: seeded random weights on the device
    cfg = get_config(args.arch)
    dtype = "float32" if args.reduced else "bfloat16"
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={args.arch} family={cfg.family} "
          f"{'reduced' if args.reduced else 'full width'}_params="
          f"{cfg.param_count()/1e6:.1f}M {dtype} device={dev}")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dtype)

    # 2) prefill + a few greedy decode steps
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen,
                           dtype=torch.int32).to(dev)
    enc = (torch.zeros((1, cfg.encoder_seq_len, cfg.d_model), device=dev)
           if cfg.family == "audio" else None)
    cache = T.init_cache(cfg, 1, 64, dtype, dev)
    with torch.no_grad():
        logits, cache, _ = T.forward(params, cfg, prompt, mode="prefill",
                                     cache=cache, encoder_input=enc)
        toks = [int(logits[0, :cfg.vocab_size].argmax())]
        for i in range(5):
            pos = torch.full((1, 1), 8 + i, dtype=torch.int32, device=dev)
            tok = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
            logits, cache, _ = T.forward(params, cfg, tok, positions=pos,
                                         mode="decode", cache=cache)
            toks.append(int(logits[0, :cfg.vocab_size].argmax()))
    print("greedy tokens:", toks)

    # 3) the serving engine on its primary (paged-KV) path: batched
    # admission, block-pool decode, on-device sampling -- one host sync
    # per step. (Attention decoders only; other families run dense.)
    if cfg.supports_paged_kv:
        from repro_torch.serving.engine import Engine
        from repro_torch.serving.request import RequestSpec
        eng = Engine(cfg, params, max_batch=2, max_len=64,
                     cache_kind="paged", block_size=8, dtype=dtype,
                     device=dev)
        rng = np.random.default_rng(0)
        for i in range(3):
            eng.submit(RequestSpec(rid=i,
                                   prompt=rng.integers(2, cfg.vocab_size,
                                                       size=6 + i)
                                   .astype(np.int32),
                                   max_tokens=6))
        done = eng.run_until_done()
        for r in sorted(done, key=lambda r: r.rid):
            print(f"paged engine rid={r.rid}: {r.generated}")
        print(f"pool end state: blocks={eng.pstate.n_blocks}, "
              f"in_use={eng.pstate.blocks_in_use()} (drained pool -> 0)")

    # 4) CoCoServe: plan a scale-up on an idle 4-device cluster
    full = get_config(args.arch)
    cluster = Cluster.homogeneous(4)
    plan = scale_up(PlacementPlan.initial(full.num_layers), cluster,
                    gamma=0.05, replica_size=layer_weight_bytes(full))
    print(f"scale-up: replicated {plan.replicated_layer_count()} layers, "
          f"continuity breaks={plan.continuity_breaks()}, "
          f"modeled speedup={speedup_homo(plan.p, 0.05):.2f}x")
    return toks


if __name__ == "__main__":
    main()
