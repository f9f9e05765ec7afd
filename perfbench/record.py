"""What one run observed: its requests, its steps and its window, on the
benchmark's host clock (``time.perf_counter`` seconds). The metric
readers (``metrics/<name>.py``) read a ``Run``; nothing here knows a
metric by name."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

@dataclasses.dataclass
class Req:
    rid: int
    due: float                 # when it was due (open loop) / sent (closed)
    prompt_len: int
    max_tokens: int
    greedy: bool
    prompt: object = None      # the prompt ids (numpy), kept for the check
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: Optional[List[int]] = None   # served ids, read after the run
    finished: Optional[float] = None     # host time it was seen finished
    truncated: bool = False    # finished with fewer tokens than asked
    prefill_start: Optional[float] = None   # host time its prefill began

    @property
    def n(self) -> int:
        return len(self.times)


@dataclasses.dataclass
class Step:
    """One ``Orchestrator.step()``: its host start and end, the engine
    clock after it, the tokens the scheduler packed, what the benchmark
    saw come out of it, and the pool blocks in use after it."""
    t0: float
    t1: float
    clock: float
    packed: Optional[int]
    decode_ctx: List[int]      # context length of each row that decoded
    first_tokens: int          # requests whose first token came out
    first_prompt_tokens: int   # ... and the prompt tokens behind them
    blocks: int = 0            # pool blocks held by requests after it

    @property
    def decode_only(self) -> bool:
        return (self.first_tokens == 0 and self.packed is not None
                and self.packed == len(self.decode_ctx))


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    model: dict                # the configuration file
    mix: dict                  # the traffic file
    t_process: float = 0.0     # when the process started, host clock
    t_open: float = 0.0        # the window, host clock
    t_close: float = 0.0
    setup_s: float = 0.0
    reqs: Dict[int, Req] = dataclasses.field(default_factory=dict)
    steps: List[Step] = dataclasses.field(default_factory=list)
    gen_lag: List[float] = dataclasses.field(default_factory=list)
    counters: Dict[str, dict] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None    # trace.reduce()'s result (--trace 1)
    drain_end: float = 0.0
    setup_marks: Dict[str, float] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------ windows
    def in_window(self, t: float) -> bool:
        return self.t_open <= t < self.t_close

    def window_reqs(self) -> List[Req]:
        """The requests sent (due) in the window."""
        return [r for r in self.reqs.values() if self.in_window(r.due)]

    def window_steps(self) -> List[Step]:
        """The steps that ran wholly inside the window."""
        return [s for s in self.steps
                if s.t0 >= self.t_open and s.t1 <= self.t_close]

    def ttfts(self) -> List[float]:
        """Seconds from due to first token of every request sent in the
        window. A request with none by the end of the drain is a miss: it
        counts as late as the drain's end, the least it could be."""
        return [(r.times[0] if r.times else self.drain_end) - r.due
                for r in self.window_reqs()]

    def window_tokens(self) -> int:
        return sum(1 for r in self.reqs.values() for t in r.times
                   if self.in_window(t))

    def gaps(self) -> List[float]:
        """Every gap between two consecutive tokens of one request, both
        seen in the window."""
        out = []
        for r in self.reqs.values():
            ts = r.times
            for a, b in zip(ts, ts[1:]):
                if self.in_window(a) and self.in_window(b):
                    out.append(b - a)
        return out


def percentile(values: List[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default); ``None`` for no values."""
    if not values:
        return None
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
