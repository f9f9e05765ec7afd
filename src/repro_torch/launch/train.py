"""Training driver: the port's counterpart of ``repro.launch.train``, with
the same flags and output lines and one more, ``--device`` (``cuda`` by
default; without CUDA it raises unless ``--device cpu`` is given).

Weights come from ``models.transformer.init_params`` with a
``torch.Generator`` seeded 0 on the device; batches from
``data.pipeline.synth_batch`` (the reference's stream); an audio model
trains over zero frames ``[B, encoder_seq_len, d_model]`` in fp32. The
per-step time is taken with the device synchronised.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch tinyllama-1.1b --reduce --steps 200 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as OPT
from repro_torch.training import train as TR


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduce", action="store_true",
                    help="train the reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--ckpt", default=None, help="path to save final ckpt")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    print(f"[train] {cfg.name} ({cfg.param_count()/1e6:.1f}M params, "
          f"family={cfg.family})")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           args.dtype)
    ocfg = OPT.OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                               total_steps=args.steps)
    opt = OPT.init_opt_state(params)
    step_fn = TR.make_train_step(cfg, ocfg)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch)

    _sync(dev)
    t0 = time.time()
    for i in range(args.steps):
        batch = synth_batch(cfg, dcfg, i, dev)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (args.batch, cfg.encoder_seq_len, cfg.d_model),
                dtype=torch.float32, device=dev)
        params, opt, metrics = step_fn(params, opt, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            _sync(dev)
            print(f"[train] step {i:4d} loss={m['loss']:.4f} "
                  f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    if args.ckpt:
        CKPT.save(args.ckpt, params, {"steps": args.steps, "arch": cfg.name})
        print(f"[train] saved {args.ckpt}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
