"""Find an open-loop cell's knee once: serve its mix at each of a few
rates in one process (fresh weights and a fresh engine a rate)
and print what each rate sustained. Not part of a benchmark run.

    python3 perfbench/sweep.py --workload <name> --rates 2,3,4 --seconds 20
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    man = harness.manifest()
    _, model, mix, _ = harness.load_cell(args.workload, man)
    for rate in [float(r) for r in args.rates.split(",")]:
        t = time.perf_counter()
        run, params, peak = harness.serve_cell(
            model, dict(mix, rate_rps=rate), args.seed, args.seconds, "cuda")
        del params
        m = harness.read_metrics(man, args.workload, run, False)
        late = [r for r in run.window_reqs() if r.times]
        third = args.seconds / 3
        early = [r.times[0] - r.due for r in late if r.due < run.t_open + third]
        last = [r.times[0] - r.due for r in late
                if r.due >= run.t_close - third]
        print(json.dumps({
            "rate_rps": rate, "sent": len(run.window_reqs()),
            "answered": len(late),
            "ttft_first_third_ms": 1e3 * sum(early) / max(len(early), 1),
            "ttft_last_third_ms": 1e3 * sum(last) / max(len(last), 1),
            "metrics": {k: v["value"] for k, v in m.items()},
            "peak_bytes": peak, "call_s": time.perf_counter() - t}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
