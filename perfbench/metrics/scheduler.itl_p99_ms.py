"""99th percentile of every gap between consecutive output tokens of
one request, over all such gaps in the window, in ms: the stall a
decoding stream sees when the scheduler packs a prefill chunk into its
step. Whether the 99th percentile lands on the steps that carry a full
chunk of the token budget turns on how the chunks fall against the
decoding rows, which moves with the host's timing from run to run."""
from perfbench.record import percentile


def read(run):
    p = percentile(run.gaps(), 99)
    return None if p is None else p * 1e3
