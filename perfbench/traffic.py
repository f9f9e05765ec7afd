"""The one traffic generator: turns a mix file (``traffic/<name>.json``)
and a seed into requests.

A mix is open or closed loop:

* ``"open"``: requests arrive on a schedule, Poisson at ``rate_rps``
  (the inter-arrival gaps of ``serving/workload.py``'s generator:
  independent exponentials with mean ``1 / rate``), whether or not
  earlier ones have finished;
* ``"closed"``: ``clients`` callers, each sending its next request when
  the previous one has finished; a client runs single requests or
  multi-turn ``sessions``.

Every size is an independent draw of the mix's distribution, made from
the mix's ``sample_seed`` (default 0). An open loop's warm-up and window
are a phase each: a phase of ``T`` seconds holds ``n = round(rate * T)``
requests, and its arrival times are ``n + 1`` independent exponential
gaps scaled to fill it, which is a Poisson process conditioned on its
count: bursts and lulls as they come, nothing evened out. Each request
keeps the sizes drawn beside its arrival, so a phase is one fixed
realisation of the mix, the same under every seed, as a replayed trace
is: which long answer comes late in the window, and which prompts land
in one burst, decide how many tokens fall inside the window and how
long the steps that carry prefill stall the streams, and a seed that
reordered them would change the work. The run's seed permutes which
requests are greedy and draws the token ids (``numpy``'s generator), and
the weights and the check's sample elsewhere. A closed loop draws a
block of one size a client at a time, in an order the seed permutes.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List, Optional

import numpy as np

UNIFORM = {"dist": "uniform", "min": 0.0, "max": 1.0}


def draws(dist: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` independent draws of a length distribution of a mix file,
    clipped to its ``min`` and ``max``."""
    kind = dist["dist"]
    if kind == "lognormal":
        x = dist["median"] * np.exp(dist["sigma"] * rng.standard_normal(n))
    elif kind == "uniform":
        x = rng.uniform(dist["min"], dist["max"], n)
    elif kind == "exponential":
        x = rng.exponential(dist["mean"], n)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(x, dist.get("min", -np.inf), dist.get("max", np.inf))


class Sample:
    """An endless stream of draws of ``dist`` in blocks of ``block``:
    each block independent draws from ``sample`` (the same whatever the
    run's seed), handed out in an order ``order`` permutes; integers
    unless ``integer`` is False."""

    def __init__(self, dist: dict, sample: np.random.Generator,
                 order: np.random.Generator, block: int,
                 integer: bool = True):
        self.dist, self.sample, self.order = dist, sample, order
        self.n, self.integer = max(1, int(block)), integer
        self._block: List[float] = []

    def __next__(self):
        if not self._block:
            xs = draws(self.dist, self.sample, self.n)
            self._block = xs[self.order.permutation(self.n)].tolist()[::-1]
        x = self._block.pop()
        return int(round(x)) if self.integer else x

    def __iter__(self):
        return self


@dataclasses.dataclass
class Draft:
    """One request as the traffic makes it: the prompt and how many
    tokens to serve. ``client`` and ``turn`` place it in a closed loop;
    ``due`` (seconds from the start of the traffic) in an open one."""
    prompt: np.ndarray
    max_tokens: int
    greedy: bool
    due: Optional[float] = None
    client: Optional[int] = None
    session: Optional[int] = None
    turn: int = 0
    turns_left: int = 0


class Traffic:
    """The requests of one mix under one seed. ``mix`` is the parsed mix
    file; ``vocab`` the model's vocabulary size; ``max_len`` the
    engine's, which bounds a session's context; ``seconds`` the
    window's length, which sizes an open loop's window phase."""

    def __init__(self, mix: dict, seed: int, vocab: int, max_len: int,
                 seconds: float = 0.0):
        self.mix = mix
        self.vocab = vocab
        self.max_len = max_len
        self.seconds = seconds
        self._order = np.random.default_rng(np.random.SeedSequence(seed))
        self.tok_rng = np.random.default_rng(
            np.random.SeedSequence([seed, 1]))
        self._sample_seed = int(mix.get("sample_seed", 0))
        block = mix.get("clients", 1)
        lengths = mix["lengths"]
        sess = mix.get("sessions")
        self.prompt_len = self._stream(lengths["prompt"], 1, block)
        self.output_len = self._stream(lengths["output"], 2, block)
        self.greedy = self._stream(UNIFORM, 3, block, integer=False)
        self.first_output = (self._stream(lengths["first_output"], 4, block)
                             if "first_output" in lengths else None)
        self.turns = (self._stream(sess["turns"], 5, block) if sess
                      else None)
        self._share = float(mix.get("greedy_share", 1.0))
        self._session_ids = 0

    def _sampler(self, *key: int) -> np.random.Generator:
        """The draws of stream ``key``: fixed by the mix, not the seed."""
        return np.random.default_rng(
            np.random.SeedSequence([self._sample_seed, *key]))

    def _stream(self, dist: dict, key: int, block: int, integer=True):
        return Sample(dist, self._sampler(key), self._order, block, integer)

    # -------------------------------------------------------------- tokens
    def _tokens(self, n: int, span: Optional[List[int]] = None) -> np.ndarray:
        lo, hi = span if span is not None else self.mix.get(
            "text_ids", [0, self.vocab])
        return self.tok_rng.integers(lo, hi, size=n, dtype=np.int64).astype(
            np.int32)

    def _is_greedy(self) -> bool:
        return next(self.greedy) < self._share

    def _fit(self, prompt: np.ndarray, out: int) -> int:
        """``out`` cut so that the prompt and the answer fit ``max_len``
        with room for the engine's last write: the engine stops a
        request at its logical length, which would cut the answer."""
        return max(1, min(out, self.max_len - 2 - len(prompt)))

    # ------------------------------------------------------------- open loop
    def arrivals(self) -> Iterator[Draft]:
        """Open loop: requests with their due times (seconds from the
        start of the warm-up), phase by phase: the warm-up, the window,
        then further windows (module docstring)."""
        rate = self.mix["rate_rps"]
        lengths = self.mix["lengths"]
        o = self._order
        start = 0.0
        for i in itertools.count():
            T = self.mix["warmup_s"] if i == 0 else self.seconds
            n = max(1, round(rate * T))
            s = self._sampler(100, i)
            prompts = draws(lengths["prompt"], s, n).round().astype(int)
            outs = draws(lengths["output"], s, n).round().astype(int)
            greedy = draws(UNIFORM, s, n) < self._share
            gaps = s.exponential(1.0, n + 1)
            greedy = greedy[o.permutation(n)]
            due = start + T * np.cumsum(gaps)[:n] / gaps.sum()
            for t, p, out, g in zip(due, prompts, outs, greedy):
                prompt = self._tokens(int(p))
                yield Draft(prompt, self._fit(prompt, int(out)), bool(g),
                            due=float(t))
            start += T

    # ----------------------------------------------------------- closed loop
    def first(self, client: int) -> Draft:
        """A closed-loop client's first request (a session's first turn
        where the mix runs sessions). ``first_output``, where the mix has
        it, staggers the clients' first completions."""
        d = self._fresh(client)
        if self.first_output is not None:
            d.max_tokens = self._fit(d.prompt, next(self.first_output))
        return d

    def _fresh(self, client: int) -> Draft:
        sess = self.mix.get("sessions")
        if not sess:
            prompt = self._tokens(next(self.prompt_len))
            return Draft(prompt, self._fit(prompt, next(self.output_len)),
                         self._is_greedy(), client=client)
        self._session_ids += 1
        image = self._tokens(sess["image_tokens"], sess["image_ids"])
        prompt = np.concatenate([image, self._tokens(next(self.prompt_len))])
        d = Draft(prompt, self._fit(prompt, next(self.output_len)),
                  self._is_greedy(), client=client,
                  session=self._session_ids, turn=1)
        d.turns_left = next(self.turns) - 1
        return d

    def follow(self, prev: Draft, served: List[int]) -> Draft:
        """The client's next request once ``prev`` has been served
        ``served``: the session's next turn (the previous prompt, its
        answer and a new question) while the session has turns left and
        the context stays within ``max_len``, else a fresh request."""
        left = prev.turns_left
        if left > 0:
            question = self._tokens(next(self.prompt_len))
            out = next(self.output_len)
            ctx = len(prev.prompt) + len(served) + len(question)
            if ctx + out + 2 <= self.max_len:
                d = Draft(np.concatenate([prev.prompt,
                                          np.asarray(served, np.int32),
                                          question]),
                          out, prev.greedy, client=prev.client,
                          session=prev.session, turn=prev.turn + 1)
                d.turns_left = left - 1
                return d
        return self._fresh(prev.client)
