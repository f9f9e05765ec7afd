"""Sums the model-level readers share: the work of the window's steps."""
from __future__ import annotations

from typing import Optional

from perfbench import roofline as RF


def window_work(run) -> Optional[dict]:
    """FLOPs and bytes the steps that ran wholly in the window needed,
    and the seconds from the first one's start to the last one's end.
    Prefill is counted at the step its first token came out; the window's
    prefix-cache hits are spread over its prompts at one share."""
    steps = run.window_steps()
    if not steps:
        return None
    m = run.model
    a, b = run.counters.get("open"), run.counters.get("close")
    bs = m["engine"]["block_size"]
    prompt_tokens = sum(s.first_prompt_tokens for s in steps)
    hit_tokens = ((b["prefix_hits"] - a["prefix_hits"]) * bs
                  if a and b else 0)
    share = min(hit_tokens / prompt_tokens, 1.0) if prompt_tokens else 0.0
    flops = nbytes = 0
    kv_tok = RF.kv_bytes_per_token(m)
    for s in steps:
        nbytes += RF.step_weight_bytes(m)
        for ctx in s.decode_ctx:
            flops += RF.decode_flops(m, ctx)
            nbytes += ctx * kv_tok
    for r in run.reqs.values():
        if r.times and steps[0].t0 <= r.times[0] <= steps[-1].t1:
            start = int(round(share * r.prompt_len))
            n = r.prompt_len - start
            flops += RF.prefill_flops(m, n, start)
            nbytes += n * kv_tok
    return {"flops": flops, "bytes": nbytes,
            "seconds": steps[-1].t1 - steps[0].t0}
