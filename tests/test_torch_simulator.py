"""Port parity, the offline simulator: repro_torch.serving.{workload,
simulator,kvcache} against the reference's copies. The workload draws
are bit-identical for a seed, the simulated results equal field for
field (every request's timings, drops, OOM events, the controller's
log, peak memory per device), and the byte accounting equals for every
config."""
import dataclasses

import pytest

from repro import configs as jax_configs
from repro.serving import kvcache as JKV
from repro.serving import simulator as JSIM
from repro.serving import workload as JWL
from repro_torch import configs as torch_configs
from repro_torch.serving import kvcache as TKV
from repro_torch.serving import simulator as TSIM
from repro_torch.serving import workload as TWL


def _rows(requests):
    return [dataclasses.astuple(r) for r in requests]


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_bit_identical(seed):
    jwl = JWL.WorkloadConfig(rps=10, duration_s=20, seed=seed)
    twl = TWL.WorkloadConfig(**dataclasses.asdict(jwl))
    want, got = _rows(JWL.generate(jwl)), _rows(TWL.generate(twl))
    assert len(got) > 100 and got == want


@pytest.mark.parametrize("pattern", ["burst", "diurnal"])
def test_generate_trace_bit_identical(pattern):
    jwl = JWL.WorkloadConfig(rps=6, duration_s=30, seed=1)
    twl = TWL.WorkloadConfig(**dataclasses.asdict(jwl))
    want = _rows(JWL.generate_trace(jwl, pattern, burst_factor=3.0))
    got = _rows(TWL.generate_trace(twl, pattern, burst_factor=3.0))
    assert len(got) > 50 and got == want


@pytest.mark.parametrize("system,rps,duration", [
    ("hft", 8, 5.0), ("vllm", 8, 5.0), ("cocoserve", 8, 5.0),
    ("hft", 30, 10.0), ("cocoserve", 30, 10.0)])
def test_simulate_equal_field_for_field(system, rps, duration):
    """llama2-13b on 4 devices at 8 rps for 5 s, as the reference's own
    simulator test runs it; and at 30 rps for 10 s, where HFT's OOM
    drops and the controller's actions happen."""
    res = {}
    for configs, sim in ((jax_configs, JSIM), (torch_configs, TSIM)):
        cfg = configs.get_config("llama2-13b")
        res[sim] = sim.simulate(
            sim.SimConfig(model=cfg, system=system, n_devices=4),
            sim.WorkloadConfig(rps=rps, duration_s=duration, seed=0))
    want, got = res[JSIM], res[TSIM]
    assert _rows(got.completed) == _rows(want.completed)
    assert len(got.completed) > 0
    for field in ("dropped", "oom_events", "sim_time", "controller_log",
                  "peak_mem_per_device"):
        assert getattr(got, field) == getattr(want, field), field
    for metric in ("mean_latency", "p95_latency", "throughput_tokens",
                   "throughput_requests"):
        assert getattr(got, metric) == getattr(want, metric), metric
    assert got.slo_attainment(12.0) == want.slo_attainment(12.0)


def test_byte_accounting_every_config():
    names = jax_configs.list_archs()
    assert len(names) == 12
    for name in names:
        j, t = jax_configs.get_config(name), torch_configs.get_config(name)
        for dtype_bytes in (2, 4):
            assert (TKV.kv_bytes_per_token(t, dtype_bytes)
                    == JKV.kv_bytes_per_token(j, dtype_bytes)), name
            assert (TKV.state_bytes(t, dtype_bytes)
                    == JKV.state_bytes(j, dtype_bytes)), name
        for swa in (False, True):
            assert (TKV.cache_capacity(t, 20000, swa=swa)
                    == JKV.cache_capacity(j, 20000, swa=swa)), name
