"""A cell's files cut to a size the CPU serves in seconds, for the
tests: two layers of width 64 and a 512-token vocabulary, lengths and
rates to match. The program runs its plain kernel versions and no
graphs on the CPU."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def files(config: str, traffic: str):
    """(model, mix): ``configs/<config>.json`` and ``traffic/<traffic>.json``
    cut to the tiny size."""
    from perfbench import harness
    model = harness._json(harness.BENCH / "configs" / f"{config}.json")
    mix = harness.load_mix(traffic)
    model = dict(model, num_hidden_layers=2, hidden_size=64,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                 intermediate_size=128, vocab_size=512,
                 engine=dict(max_batch=4, max_len=256, block_size=16,
                             n_blocks=96, token_budget=64,
                             prefix_sharing=True))
    mix = copy.deepcopy(mix)
    mix["engine"] = {}
    mix["warmup_s"] = 0.5
    lengths = mix["lengths"]
    for key, lo, hi, med in (("prompt", 8, 96, 40), ("output", 4, 32, 12),
                             ("first_output", 1, 32, 12)):
        if key not in lengths:
            continue
        d = lengths[key]
        d.update(min=lo, max=hi)
        if "median" in d:
            d["median"] = med
    if "sessions" in mix:
        mix["sessions"].update(image_tokens=40, image_ids=[4, 100])
        mix["text_ids"] = [100, 512]
    if mix["loop"] == "open":
        mix["rate_rps"] = 4.0
    else:
        mix["clients"] = 4
    return model, mix

