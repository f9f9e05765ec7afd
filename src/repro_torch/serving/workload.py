"""Workload generation: Poisson arrivals with Alpaca-like length profiles.

The paper evaluates with the Alpaca dataset, max generation length 256, at
request rates 3-55 RPS. We reproduce the shape statistically: prompt lengths
lognormal around ~64 tokens, output lengths capped at 256.

Copy of ``repro.serving.workload`` for the port: the same numpy draws in
the same order, so a seed gives the reference's requests bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SimRequest:
    rid: int
    arrival: float
    prompt_len: int
    output_len: int
    # filled by the simulator
    first_token: float = -1.0
    finish: float = -1.0
    generated: int = 0
    dropped: bool = False

    @property
    def latency(self) -> float:
        return self.finish - self.arrival if self.finish >= 0 else float("inf")


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    rps: float = 10.0
    duration_s: float = 60.0
    seed: int = 0
    mean_prompt: float = 64.0
    max_output: int = 256
    mean_output: float = 64.0   # Alpaca-like outputs, capped at 256


def generate(cfg: WorkloadConfig) -> List[SimRequest]:
    rng = np.random.default_rng(cfg.seed)
    t = 0.0
    out: List[SimRequest] = []
    rid = 0
    while True:
        t += rng.exponential(1.0 / cfg.rps)
        if t > cfg.duration_s:
            break
        plen = int(np.clip(rng.lognormal(np.log(cfg.mean_prompt), 0.6), 8, 512))
        olen = int(np.clip(rng.exponential(cfg.mean_output), 4, cfg.max_output))
        out.append(SimRequest(rid=rid, arrival=t, prompt_len=plen,
                              output_len=olen))
        rid += 1
    return out


def generate_trace(cfg: WorkloadConfig, pattern: str = "burst",
                   burst_factor: float = 4.0) -> List[SimRequest]:
    """Non-stationary traffic (the paper's 'unpredictable traffic patterns'):

    * ``burst``   — baseline RPS with a burst_factor spike in the middle
      third of the run (tests scale-down reactions);
    * ``diurnal`` — sinusoidal rate between 0.25x and 1.75x of cfg.rps
      (tests scale-up re-use of freed capacity).
    """
    rng = np.random.default_rng(cfg.seed)
    t, rid = 0.0, 0
    out: List[SimRequest] = []
    while t < cfg.duration_s:
        frac = t / cfg.duration_s
        if pattern == "burst":
            rate = cfg.rps * (burst_factor if 1 / 3 <= frac <= 2 / 3 else 1.0)
        else:  # diurnal
            rate = cfg.rps * (1.0 + 0.75 * np.sin(2 * np.pi * frac))
            rate = max(rate, 0.25 * cfg.rps)
        t += rng.exponential(1.0 / rate)
        if t > cfg.duration_s:
            break
        plen = int(np.clip(rng.lognormal(np.log(cfg.mean_prompt), 0.6), 8, 512))
        olen = int(np.clip(rng.exponential(cfg.mean_output), 4, cfg.max_output))
        out.append(SimRequest(rid=rid, arrival=t, prompt_len=plen,
                              output_len=olen))
        rid += 1
    return out
