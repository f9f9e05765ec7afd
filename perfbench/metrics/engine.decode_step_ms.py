"""Median host wall of the window's decode-only steps (no prefill token
packed, no first token out), in ms."""
from perfbench.record import percentile


def read(run):
    walls = [s.t1 - s.t0 for s in run.window_steps() if s.decode_only]
    p = percentile(walls, 50)
    return None if p is None else p * 1e3
