"""Median wait from a window request's due time to the
start of the step that began its prefill (``Request.prefill_start_time``,
an engine-clock step, mapped to that step's host start)."""
from perfbench.record import percentile


def read(run):
    waits = [(r.prefill_start if r.prefill_start is not None
              else run.drain_end) - r.due for r in run.window_reqs()]
    p = percentile(waits, 50)
    return None if p is None else p * 1e3
