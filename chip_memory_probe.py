"""Where a step's measured peak on the card departs from the dry run's
meta tally (card only).

    python3 chip_memory_probe.py

For phase 14b's remat call (tinyllama-1.1b bf16, batch 8 x seq 1024) and
14a's bf16 train step (batch 8 x seq 128), it runs the call under
``launch.dryrun.MemoryTally`` on meta copies of the arguments, then on
the card under the same tally extended to read, around every op,
``torch.cuda.memory_allocated()`` and the op's own peak
(``max_memory_allocated`` after ``reset_peak_memory_stats``). It prints
the meta tally's and the card tally's temp (equal where the meta kernels
allocate what the card's do), the ops whose kernels hold the most
scratch while they run (the op's peak beyond its bytes before and
after: what no dispatch mode sees, ``MemoryTally.SCRATCH``), and the gap
between the card's allocated bytes and the tally after each op.
"""
import collections
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import chip_smoke as CS  # noqa: E402


def probe(DR):
    class Probe(DR.MemoryTally):
        """The tally, with the card's allocated bytes around every op."""

        def __init__(self, args):
            super().__init__(args)
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = super().__torch_dispatch__(func, types, args, kwargs)
            self.rows.append((str(func), self.bytes, before, torch.cuda.memory_allocated(),
                              torch.cuda.max_memory_allocated()))
            return out

    return Probe


def report(DR, name, fn, args, smi):
    meta = CS.meta_like(args)
    tally = DR.MemoryTally(meta)
    with tally:
        fn(*meta)
    del meta
    CS.reset_peak("cuda")
    start = torch.cuda.memory_allocated()
    card = probe(DR)(args)
    with card:
        out = fn(*args)
    torch.cuda.synchronize()
    del out
    rows = card.rows
    scratch = collections.Counter()
    for op, _, before, after, peak in rows:
        scratch[op] = max(scratch[op], peak - max(before, after))
    gap = max(after - (start - card.base) - tally_b for _, tally_b, _, after, _ in rows)
    CS.log(f"[memory] {name}: {len(rows)} ops; meta tally temp {tally.temp} B, card tally "
           f"temp {card.temp} B (base {card.base} B, allocated at the start {start} B); the "
           f"card's peak over the ops {max(r[4] for r in rows)} B against the tally's "
           f"arguments + temp {tally.base + tally.temp} B; the largest scratch an op's "
           f"kernel held while it ran: {scratch.most_common(4)}; allocated less the tally "
           f"after an op, at most {gap} B [{smi}]")


def main():
    if not torch.cuda.is_available():
        print("chip_memory_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as DP
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train as TR

    smi = CS.nvidia_smi_line()
    cfg = get_config("tinyllama-1.1b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(CS.SEED),
                           "bfloat16")
    batch = DP.synth_batch(cfg, DP.DataConfig(seq_len=1024, global_batch=8), 0)
    report(DR, "14b remat loss and gradients, batch 8 x seq 1024",
           lambda p, b: TR.value_and_grad(TR.make_loss_fn(cfg, remat=True), p, b),
           (params, batch), smi)
    batch = DP.synth_batch(cfg, DP.DataConfig(seq_len=128, global_batch=8), 0)
    step = TR.make_train_step(cfg, OPT.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                       total_steps=10))
    params, opt, _ = step(params, OPT.init_opt_state(params), batch)
    report(DR, "14a bf16 train step, batch 8 x seq 128", step, (params, opt, batch), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
