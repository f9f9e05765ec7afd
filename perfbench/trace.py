"""The traced run's device timeline: ``torch.profiler`` over the whole
window (device activity only; kernels inside CUDA-graph replays are
recorded one by one), reduced in memory once the window has closed.
Nothing is written to disk.

Kineto stamps device activity on the host's realtime clock in
nanoseconds; the benchmark's host spans (``span``) are taken on
``time.perf_counter`` and moved onto that clock by one offset measured
at start."""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import torch

#: how long a kernel name is kept in a breakdown entry
NAME_CHARS = 160


class Tracer:
    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.spans: List[Tuple[str, float, float]] = []   # host spans
        self._prof = None
        self.start_s = self.stop_s = 0.0

    def warm(self):
        """Pay the profiler's first start (CUPTI's set-up, seconds) in the
        set-up, on a throwaway window."""
        from torch.profiler import ProfilerActivity, profile
        x = torch.ones(16, device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]):
            (x + 1).sum().item()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        t = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.start_s = time.perf_counter() - t

    def stop(self):
        t = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t

    def span(self, name: str, t0: float, t1: float):
        self.spans.append((name, t0, t1))

    def _ns(self, t: float) -> int:
        return int(t * 1e9) + self.offset_ns

    def reduce(self, t_open: float, t_close: float) -> dict:
        """Device time by kernel name, busy seconds (the union of every
        device activity) and the idle gaps by the host span they fell
        in, over [t_open, t_close)."""
        lo, hi = self._ns(t_open), self._ns(t_close)
        t = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        ivs = []
        by_name: Dict[str, int] = {}
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            a, b = e.start_ns(), e.end_ns()
            if b <= lo or a >= hi:
                continue
            a, b = max(a, lo), min(b, hi)
            name = e.name()
            by_name[name] = by_name.get(name, 0) + (b - a)
            ivs.append((a, b))
        self._prof = None
        n_ops = len(ivs)
        ivs.sort()
        busy = 0
        gaps = []
        cur = None
        for a, b in ivs:
            if cur is None:
                if a > lo:
                    gaps.append((lo, a))
                cur = [a, b]
            elif a > cur[1]:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        if cur is None:
            gaps.append((lo, hi))
        else:
            busy += cur[1] - cur[0]
            if hi > cur[1]:
                gaps.append((cur[1], hi))
        idle = self._attribute(gaps)
        return {
            "window_s": (hi - lo) / 1e9,
            "busy_s": busy / 1e9,
            "device_ops": n_ops,
            "by_name_s": {k: v / 1e9 for k, v in by_name.items()},
            "idle_by_host_s": idle,
            "reduce_s": time.perf_counter() - t,
            "profiler_start_s": self.start_s,
            "profiler_stop_s": self.stop_s,
        }

    def _attribute(self, gaps) -> Dict[str, float]:
        """Idle nanoseconds by the host span that covered them ("other"
        where no span did)."""
        spans = sorted((self._ns(a), self._ns(b), n) for n, a, b in self.spans)
        out: Dict[str, float] = {}
        j = 0
        for ga, gb in gaps:
            covered = 0
            while j < len(spans) and spans[j][1] <= ga:
                j += 1
            k = j
            while k < len(spans) and spans[k][0] < gb:
                a, b, n = spans[k]
                ov = min(b, gb) - max(a, ga)
                if ov > 0:
                    out[n] = out.get(n, 0.0) + ov / 1e9
                    covered += ov
                k += 1
            if gb - ga > covered:
                out["other"] = out.get("other", 0.0) + (gb - ga - covered) / 1e9
        return out


def kernel_seconds(trace: dict, patterns: List[str]) -> float:
    """Device seconds of the kernels whose names match any of
    ``patterns`` (regular expressions, searched)."""
    rx = [re.compile(p) for p in patterns]
    return sum(s for n, s in trace["by_name_s"].items()
               if any(r.search(n) for r in rx))


def breakdown(trace: dict) -> Optional[dict]:
    ops = sorted(trace["by_name_s"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace["idle_by_host_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
