"""Share of the prompt blocks looked up in the window that the prefix
cache served (``paged_kv`` prefix_hits / prefix_queries deltas), in %."""


def read(run):
    a, b = run.counters.get("open"), run.counters.get("close")
    if not a or not b:
        return None
    q = b["prefix_queries"] - a["prefix_queries"]
    return 100.0 * (b["prefix_hits"] - a["prefix_hits"]) / q if q else None
