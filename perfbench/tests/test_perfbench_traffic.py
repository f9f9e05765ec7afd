"""The traffic generator: seeded, Poisson in the open loop, clipped, and
fitted to the engine's length."""
import collections

import numpy as np
import pytest

from perfbench.tests import tiny  # noqa: F401  (puts src on the path)
from perfbench import harness
from perfbench.traffic import Sample, Traffic


def _mix(name):
    return harness.load_mix(name)


def _open(seed, rate=None, seconds=50.0):
    mix = _mix("chat")
    if rate is not None:
        mix = dict(mix, rate_rps=rate)
    t = Traffic(mix, seed, 100352, 4096, seconds)
    n_warm = round(mix["rate_rps"] * mix["warmup_s"])
    n_win = round(mix["rate_rps"] * seconds)
    gen = t.arrivals()
    warm = [next(gen) for _ in range(n_warm)]
    return mix, warm, [next(gen) for _ in range(n_win)]


def test_same_seed_same_requests():
    _, _, a = _open(2**31 + 17)
    _, _, b = _open(2**31 + 17)
    for x, y in zip(a, b):
        assert x.due == y.due and x.max_tokens == y.max_tokens
        assert np.array_equal(x.prompt, y.prompt)


def test_seeds_send_the_same_window_in_another_order():
    """Every seed sends the same requests at the same times with the same
    sizes; the seed orders the greedy flags and draws the tokens."""
    (mix, w1, a), (_, w2, b) = _open(1), _open(2**33 + 5)
    start = mix["warmup_s"]
    for win in (a, b):
        assert all(start <= d.due < start + 50.0 for d in win)
    for x, y in zip(w1 + a, w2 + b):
        assert x.due == y.due and x.max_tokens == y.max_tokens
        assert len(x.prompt) == len(y.prompt)
    assert sorted(d.greedy for d in a) == sorted(d.greedy for d in b)
    assert [d.greedy for d in w1 + a] != [d.greedy for d in w2 + b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)


@pytest.mark.parametrize("dist,lo,hi,median", [
    ({"dist": "lognormal", "median": 1024, "sigma": 0.8, "min": 64,
      "max": 3072}, 64, 3072, 1024),
    ({"dist": "uniform", "min": 2048, "max": 3072}, 2048, 3072, 2560),
])
def test_lengths_keep_their_distribution_and_clips(dist, lo, hi, median):
    s = Sample(dist, np.random.default_rng(0), np.random.default_rng(1),
               block=64)
    xs = [next(s) for _ in range(64 * 32)]
    assert min(xs) >= lo and max(xs) <= hi
    assert abs(float(np.median(xs)) - median) <= 0.08 * median


def test_arrivals_are_poisson_not_evened_out():
    """Gaps as exponential as drawn (coefficient of variation ~1), and
    ten-second stretches of a window that carry unlike loads."""
    mix, _, win = _open(3, rate=2.5, seconds=400.0)
    due = np.array([d.due for d in win])
    gaps = np.diff(due)
    assert 0.85 < gaps.std() / gaps.mean() < 1.15
    per10 = np.histogram(due, bins=40, range=(mix["warmup_s"],
                                              mix["warmup_s"] + 400.0))[0]
    assert per10.min() <= 25 - 8 and per10.max() >= 25 + 8


def test_open_loop_rate():
    mix, warm, win = _open(9, rate=2.5, seconds=40.0)
    assert len(win) == 100 and len(warm) == round(2.5 * mix["warmup_s"])
    assert all(d.due < mix["warmup_s"] for d in warm)


def test_prompt_and_answer_fit_the_engine():
    mix = _mix("longctx")
    t = Traffic(mix, 4, 100352, 4096, 50.0)
    for c in range(48):
        d = t.first(c)
        assert len(d.prompt) + d.max_tokens <= 4096 - 2
        assert 1 <= d.max_tokens <= 1024


def test_sessions_grow_by_answer_and_question_within_max_len():
    mix = _mix("image-sessions")
    t = Traffic(mix, 5, 65536, 4096, 50.0)
    turns = collections.Counter()
    for c in range(16):
        d = t.first(c)
        lo, hi = mix["sessions"]["image_ids"]
        assert d.turn == 1 and (d.prompt[:1024] >= lo).all() \
            and (d.prompt[:1024] < hi).all()
        assert (d.prompt[1024:] >= mix["text_ids"][0]).all()
        while True:
            served = list(range(8196, 8196 + d.max_tokens))
            nxt = t.follow(d, served)
            if nxt.session != d.session:
                break
            assert np.array_equal(nxt.prompt[:len(d.prompt)], d.prompt)
            assert nxt.prompt[len(d.prompt):len(d.prompt) + len(served)] \
                .tolist() == served
            assert len(nxt.prompt) + nxt.max_tokens + 2 <= 4096
            d = nxt
        turns[d.turn] += 1
    assert set(turns) <= {1, 2, 3, 4, 5} and max(turns) >= 2
