"""Median time to first token over the requests sent in the window,
from when each was due (a request never answered counts as a miss)."""
from perfbench.record import percentile


def read(run):
    p = percentile(run.ttfts(), 50)
    return None if p is None else p * 1e3
