"""The readings a cell's limits are set from, on the card at the cell's
own size: for each seed, a run of the cell (a short window at its own
load), then the widest logit gap of the program's served greedy tokens
and of the tokens the float8 control (the reference with every matrix
product in float8 e4m3) puts first, at the same positions. One JSON
line a seed. Not part of a benchmark run.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --seconds 10
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import check, harness
    man = harness.manifest()
    _, model, mix, _ = harness.load_cell(args.workload, man)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        run, params, peak = harness.serve_cell(model, mix, seed,
                                               args.seconds, "cuda")
        rids = check.sample(run, int(mix["check_requests"]))
        prog = check.gaps(params, run.model, run, rids)
        ctrl = check.gaps(params, run.model, run, rids, quant="fp8")
        line = {"seed": seed, "program": prog["max_logit_gap"],
                "control_fp8": ctrl["max_logit_gap"],
                "tokens": prog["tokens"], "counts": check.counts(run),
                "peak_bytes": peak, "call_s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        del run, params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
