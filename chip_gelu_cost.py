"""What the form of gelu costs end to end on the card (card only).

    python3 chip_gelu_cost.py

gemma-7b (28 layers, GeGLU with d_ff 24576) and whisper-medium (24
encoder and 24 decoder layers, a gelu MLP with d_ff 4096) at their
published widths in bf16, random weights from a seeded generator, with
``models.layers._gelu`` bound in turn to each of three forms, in the
order fused, chain, kernel, kernel, chain, fused:

- fused: torch's ``F.gelu(x, approximate="tanh")``, one launch that
  rounds once (the port's gelu before C6 was fixed; bf16 outputs differ
  from the reference's);
- chain: ``kernels.gelu.gelu_ref``, XLA's op chain in torch ops, a launch
  and a rounding an op (the plain version);
- kernel: the port's ``_gelu``, the same chain in one launch
  (``kernels/csrc/gelu.cu``).

For each form: gemma-7b's prefill of one 600-token prompt (``forward``
over a dense cache) and whisper-medium's encoder over its 1500 fp32
frames, each the median of 5 calls after 2 (CUDA events); and each
model's steady decode-step median through its engine's CUDA graphs, on
phase 5's workload as phases 16a (gemma-7b, paged) and 11b
(whisper-medium, dense, prompts cut to 416 tokens) serve it, a fresh
engine per run so that its graphs hold the form. Every line carries the
card's name and power limit.
"""
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import chip_smoke as CS  # noqa: E402

ORDER = ("fused", "chain", "kernel", "kernel", "chain", "fused")


def event_ms(fn, reps=5, warm=2):
    """Median device-and-host ms of ``fn()`` over ``reps`` calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("chip_gelu_cost: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import migration as MIG
    from repro_torch.kernels import gelu as GK
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import RequestSpec, SamplingParams

    smi = CS.nvidia_smi_line()
    forms = {"fused": lambda x: F.gelu(x, approximate="tanh"), "chain": GK.gelu_ref,
             "kernel": L._gelu}
    results = {}
    for arch in ("gemma-7b", "whisper-medium"):
        cfg = get_config(arch)
        t = time.perf_counter()
        params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(CS.SEED),
                               "bfloat16")
        torch.cuda.synchronize()
        weight_bytes, init_s = MIG.tree_bytes(params), time.perf_counter() - t
        prompts, sampled = CS.workload(cfg)
        if cfg.family == "audio":
            prompts = [p[:CS.WHISPER_PROMPT] for p in prompts]
            frames = torch.randn((1, cfg.encoder_seq_len, cfg.d_model), device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(1))

            def prefill():
                return T.encode_audio(params, cfg, frames)

            kw = dict(CS.DENSE_KW, max_len=CS.WHISPER_MAX_LEN,
                      encoder_input_fn=CS.whisper_frames(cfg))
            what = "encoder over 1500 frames"
        else:
            toks = torch.randint(2, cfg.vocab_size, (1, 600), device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(1))
            last = torch.tensor([599], dtype=torch.int32, device="cuda")

            def prefill():
                cache = T.init_cache(cfg, 1, 1024, "bfloat16", "cuda")
                return T.forward(params, cfg, toks, cache=cache, mode="prefill",
                                 last_idx=last)

            kw = dict(CS.ENGINE_KW, paged_attn_impl="kernel")
            what = "prefill of 600 tokens"
        print(f"[gelu-cost] {arch}: {cfg.num_layers} layers, d={cfg.d_model}, d_ff "
              f"{cfg.d_ff} ({cfg.ffn_kind}); bf16 weights {weight_bytes} B in {init_s:.1f} s "
              f"[{smi}]", flush=True)
        for form in ORDER:
            L._gelu = forms[form]
            try:
                with torch.no_grad():
                    pre_ms = event_ms(prefill)
                t = time.perf_counter()
                eng = Engine(cfg, params, device="cuda", cuda_graphs=True, **kw)
                _, reqs, stats = CS.run_engine(Engine, RequestSpec, SamplingParams, cfg,
                                               params, "kernel", prompts, sampled, eng=eng)
                del eng
            finally:
                L._gelu = forms["kernel"]
            steps = stats["steady_step_ms"]
            step_ms = steps[len(steps) // 2]
            results.setdefault((arch, form), []).append((pre_ms, step_ms))
            print(f"[gelu-cost] {arch} {form}: {what} {pre_ms:.3f} ms; steady decode step "
                  f"median {step_ms:.3f} ms over {len(steps)} steps; served "
                  f"{sum(len(r.generated) for r in reqs)} tokens in "
                  f"{time.perf_counter() - t:.1f} s [{smi}]", flush=True)
        del params
        torch.cuda.empty_cache()
    for (arch, form), runs in results.items():
        pre = [p for p, _ in runs]
        step = [s for _, s in runs]
        print(f"[gelu-cost] {arch} {form}: prefill ms {pre}, step ms {step} [{smi}]")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
