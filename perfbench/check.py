"""Whether the timed path served the right tokens: the comparison that
decides ``correct``.

Once the window has closed and the program is freed, a sample of the
greedy requests the timed path served, drawn from the seed and with the
longest among them, runs through the plain float32 reference
(``reference/<layout>.py``, the
configuration file's ``reference``) over its prompt and served tokens. A greedy
token is the argmax of the program's logits, so the reference's best
logit at that position lies above the served token's by a gap that
only rounding opens; the number compared is the widest such gap
(``max_logit_gap``). The control puts the reference in float8
(``quant="fp8"``) in the program's place and reads the gap of the token
the float8 logits put first at the same positions.

Two counts are held to 0 besides: requests sent in the window that got
no token by the end of the drain (``unanswered``) and finished requests
served fewer tokens than they asked for (``short_answers``)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.record import Run
from perfbench.reference import layout


def sample(run: Run, k: int) -> List[int]:
    """Rids of up to ``k`` greedy requests with tokens served in the
    window: the one with the most served tokens, and the rest drawn from
    the seed."""
    cands = sorted(r.rid for r in run.reqs.values()
                   if r.greedy and r.tokens and r.times
                   and r.times[-1] >= run.t_open)
    if not cands:
        return []
    longest = max(cands, key=lambda rid: (len(run.reqs[rid].tokens), -rid))
    rest = [c for c in cands if c != longest]
    rng = np.random.default_rng(np.random.SeedSequence([run.seed, 7]))
    pick = list(rng.choice(rest, size=min(k - 1, len(rest)), replace=False))
    return [longest] + sorted(int(r) for r in pick)


def gaps(params: dict, m: dict, run: Run, rids: List[int],
         quant: Optional[str] = None) -> Dict[str, float]:
    """The widest gap of the reference's best logit over the judged
    token: the served one, or, under ``quant``, the one the reference at
    that precision ranks first. Also the tokens judged."""
    seqs, rows, served = [], [], []
    for rid in rids:
        r = run.reqs[rid]
        toks = list(map(int, r.tokens))
        P = len(r.prompt)
        seqs.append(list(map(int, r.prompt)) + toks[:-1])
        rows.append(slice(P - 1, P - 1 + len(toks)))
        served.append(toks)
    Reference = layout(m).Reference
    ref = Reference(params, m).logits(seqs, rows)
    ctrl = (Reference(params, m, quant).logits(seqs, rows) if quant
            else [None] * len(ref))
    worst = 0.0
    n = 0
    for lg, c, toks in zip(ref, ctrl, served):
        judged = (c.argmax(-1) if c is not None
                  else torch.as_tensor(toks, device=lg.device))
        gap = lg.max(-1).values - lg.gather(-1, judged[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        n += len(toks)
    return {"max_logit_gap": worst, "tokens": n}


def counts(run: Run) -> Dict[str, int]:
    unanswered = sum(1 for r in run.window_reqs() if not r.times)
    short = sum(1 for r in run.reqs.values()
                if r.finished is not None and r.truncated)
    return {"unanswered": unanswered, "short_answers": short}


def judge(params, m: dict, run: Run, limits: dict, k: int) -> dict:
    """Every number compared, beside its limit, and ``correct``."""
    rids = sample(run, k)
    out = {}
    c = counts(run)
    out["unanswered"] = {"value": c["unanswered"], "limit": 0}
    out["short_answers"] = {"value": c["short_answers"], "limit": 0}
    if rids:
        g = gaps(params, m, run, rids)
        out["max_logit_gap"] = {"value": g["max_logit_gap"],
                                "limit": limits["max_logit_gap"]}
        out["judged_tokens"] = {"value": g["tokens"], "least": 1}
    else:
        out["judged_tokens"] = {"value": 0, "least": 1}
    ok = (out["unanswered"]["value"] <= 0
          and out["short_answers"]["value"] <= 0
          and out["judged_tokens"]["value"] >= 1
          and "max_logit_gap" in out
          and out["max_logit_gap"]["value"] <= out["max_logit_gap"]["limit"])
    return {"correct": bool(ok), "checks": out}
