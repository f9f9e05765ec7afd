"""The bf16 rounding error of a model's logits at full width and a cut
depth, in the reference (JAX) and in the port (PyTorch, plain routes) on
the same weights: the witness that a gap between bf16 and fp32 logits
belongs to bf16 itself and not to either package.

For each depth in ``--layers``, the configuration keeps its published
widths and takes that many layers (for zamba2-7b, 6 layers are one
Mamba2 block and one application of the shared block). The weights are
the reference's ``init_params`` in bf16 (``--seed``); the fp32 run uses
the same weights widened, as ``chip_smoke.py`` widens them. One prompt
of ``--prompt`` tokens (numpy, ``--seed``) is prefilled over a fresh
batch-1 cache, as the dense engine admits a request, and the first
token's logits are compared by relative L2:

* ``ref bf16 vs fp32`` and ``port bf16 vs fp32``: each package's own
  bf16 error;
* ``port vs ref``: the two packages in the same dtype.

Run on the CPU (a 6-layer zamba2-7b holds 1.6 GB of bf16 weights; the
script keeps one package's two copies at a time):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_bf16_gap.py \\
        --arch zamba2-7b --layers 6 12
"""
import argparse
import dataclasses
import gc
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jax_configs
from repro.models import transformer as JT
from repro_torch import configs as torch_configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import transformer as TT


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def reference_logits(cfg, params, toks):
    """First-token logits of the reference's prefill, in bf16 and in
    fp32 on the widened weights."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = params if dtype == "bfloat16" else jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), params)
        fn = jax.jit(lambda p, t: JT.forward(
            p, cfg, t, mode="prefill",
            cache=JT.init_cache(cfg, 1, t.shape[1], dtype))[0])
        out[dtype] = np.asarray(fn(p, jnp.asarray(toks)), np.float32)
        del p, fn
    return out


def port_logits(cfg, tree, toks):
    """The same through the port's plain routes on the CPU."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = params_from_numpy(tree, "cpu",
                              None if dtype == "bfloat16" else torch.float32)
        cache = TT.init_cache(cfg, 1, toks.shape[1], dtype, "cpu")
        with torch.no_grad():
            logits = TT.forward(p, cfg, torch.from_numpy(toks), mode="prefill",
                                cache=cache, attn_impl="gather",
                                ssd_impl="chunked")[0]
        out[dtype] = logits.float().numpy()
        del p, cache
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, nargs="+", default=[6])
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    for n in args.layers:
        t0 = time.perf_counter()
        jcfg = dataclasses.replace(jax_configs.get_config(args.arch),
                                   num_layers=n)
        tcfg = dataclasses.replace(torch_configs.get_config(args.arch),
                                   num_layers=n)
        rng = np.random.default_rng(args.seed)
        toks = rng.integers(2, jcfg.vocab_size,
                            size=(1, args.prompt)).astype(np.int32)
        jp = jax.jit(lambda: JT.init_params(
            jcfg, jax.random.PRNGKey(args.seed), "bfloat16"))()
        ref = reference_logits(jcfg, jp, toks)
        tree = jax.tree_util.tree_map(np.asarray, jp)
        del jp
        gc.collect()
        port = port_logits(tcfg, tree, toks)
        del tree
        gc.collect()
        print(json.dumps({
            "arch": args.arch, "layers": n, "prompt": args.prompt,
            "seed": args.seed,
            "ref_bf16_vs_fp32": rel_l2(ref["bfloat16"], ref["float32"]),
            "port_bf16_vs_fp32": rel_l2(port["bfloat16"], port["float32"]),
            "port_vs_ref_fp32": rel_l2(port["float32"], ref["float32"]),
            "port_vs_ref_bf16": rel_l2(port["bfloat16"], ref["bfloat16"]),
            "seconds": round(time.perf_counter() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
