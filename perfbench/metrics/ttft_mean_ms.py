"""Mean time to first token over the requests sent in the window, from
when each was due (a request never answered counts as a miss)."""


def read(run):
    t = run.ttfts()
    return 1e3 * sum(t) / len(t) if t else None
