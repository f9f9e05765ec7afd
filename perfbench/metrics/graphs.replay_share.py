"""Decode steps replayed from a CUDA graph over all decode steps in the
window (``Engine.graphs.counts``); a capture inside the window shows
here, in %."""


def read(run):
    a, b = run.counters.get("open"), run.counters.get("close")
    if not a or not b:
        return None

    def d(kind):
        return b[kind].get("decode", 0) - a[kind].get("decode", 0)

    total = d("replays") + d("captures") + d("eager")
    return 100.0 * d("replays") / total if total else None
