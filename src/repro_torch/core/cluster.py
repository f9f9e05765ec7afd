"""Cluster abstraction shared by the auto-scaling algorithms and simulator.

Devices model the paper's testbed (A100-40GB) by default but take arbitrary
compute/memory/bandwidth. Module memory/compute footprints come from the
analytic Table-1 model in :func:`module_profile`. Copy of
``repro.core.cluster`` for the port, whose dry-run target is the H100
(``Cluster.h100``) where the reference's is the TPU v5e
(``tpu_v5e``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

GB = 1024 ** 3


@dataclasses.dataclass
class Device:
    device_id: int
    mem_capacity: float = 40 * GB          # A100-40GB
    compute_flops: float = 312e12          # A100 bf16 dense, FLOP/s
    used_mem: float = 0.0
    # instantaneous load signals fed by the Monitor
    util_compute: float = 0.0              # 0..1
    util_mem: float = 0.0                  # 0..1

    @property
    def free_mem(self) -> float:
        return max(0.0, self.mem_capacity - self.used_mem)

    @property
    def vacancy_rate(self) -> float:
        return 1.0 - max(self.util_compute, self.used_mem / self.mem_capacity)


@dataclasses.dataclass
class Cluster:
    devices: List[Device]
    link_bandwidth: float = 64 * GB        # NVLink-ish

    def eligible_nodes(self, min_vacancy: float = 0.2) -> List[Device]:
        """GetEligibleNodes(G) — filtered by resource vacancy rate (Alg. 1)."""
        return sorted((d for d in self.devices
                       if d.vacancy_rate >= min_vacancy),
                      key=lambda d: -d.vacancy_rate)

    def device(self, device_id: int) -> Device:
        return self.devices[device_id]

    @staticmethod
    def homogeneous(n: int, *, mem_gb: float = 40.0, flops: float = 312e12,
                    link_gbps: float = 64.0) -> "Cluster":
        return Cluster(
            devices=[Device(i, mem_capacity=mem_gb * GB,
                            compute_flops=flops) for i in range(n)],
            link_bandwidth=link_gbps * GB)

    @staticmethod
    def h100(n: int) -> "Cluster":
        """The port's dry-run target: ``n`` NVIDIA H100 SXM cards, each
        80 GB of HBM3 and 989 TFLOP/s dense bf16, joined by NVLink at
        450 GB/s a direction (NVIDIA's H100 data sheet, SXM column;
        decimal GB). The chip machine's card reports itself as "NVIDIA
        H100 80GB HBM3, 700.00 W" (``nvidia-smi --query-gpu=name,
        power.limit``); at a lower power limit a card runs slower."""
        return Cluster(
            devices=[Device(i, mem_capacity=80e9, compute_flops=989e12)
                     for i in range(n)],
            link_bandwidth=450e9)


# --------------------------------------------------------- module footprints
def module_profile(cfg: ModelConfig, *, batch: int = 1, seq: int = 256,
                   dtype_bytes: int = 2) -> Dict[str, Dict[str, float]]:
    """Analytic per-module memory (weight bytes) and compute (FLOPs) — the
    reproduction of the paper's Table 1 (benchmarks/table1_modules.py prints
    it for LLaMA-13B geometry and checks against the paper's numbers)."""
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    toks = batch * seq
    out: Dict[str, Dict[str, float]] = {}

    qkvo_params = d * H * hd + 2 * d * KV * hd + H * hd * d
    proj_one = d * H * hd                      # a single projection (Q or O)
    out["self_attn.q/k/v/o_proj"] = {
        "mem": proj_one * dtype_bytes,
        "flops": 2 * toks * proj_one,
    }
    attn_scores = 2 * 2 * batch * H * seq * seq * hd  # QK^T + AV
    out["self_attn"] = {
        "mem": qkvo_params * dtype_bytes,
        "flops": 2 * toks * qkvo_params,
        "extra_flops_scores": attn_scores,
    }
    # Table 1's "ffn.gate/up/down_proj" row is a SINGLE [d, d_ff] projection
    # (135 MB / 36.24 GFLOPs for LLaMA-13B), mirroring the per-projection
    # attention row.
    ffn_proj = d * ff
    out["ffn.gate/up/down_proj"] = {
        "mem": ffn_proj * dtype_bytes,
        "flops": 2 * toks * ffn_proj,
    }
    ffn_params = 3 * d * ff if cfg.ffn_kind in ("swiglu", "geglu") else 2 * d * ff
    layer_params = qkvo_params + ffn_params + 2 * d
    # activations + norms dominate the delta the paper reports for a layer
    act_mem = toks * (2 * d + ff) * dtype_bytes
    out["decoder_layer"] = {
        "mem": layer_params * dtype_bytes + act_mem,
        "flops": 2 * toks * layer_params + attn_scores,
    }
    out["kv_cache_per_token"] = {
        "mem": 2 * KV * hd * dtype_bytes * cfg.num_layers,
        "flops": 0.0,
    }
    return out


def layer_weight_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    prof = module_profile(cfg, dtype_bytes=dtype_bytes)
    d = cfg.d_model
    qkvo = prof["self_attn"]["mem"]
    n_proj = 3 if cfg.ffn_kind in ("swiglu", "geglu") else 2
    ffn = n_proj * prof["ffn.gate/up/down_proj"]["mem"]
    return qkvo + ffn + 2 * d * dtype_bytes


def layer_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    prof = module_profile(cfg, batch=batch, seq=seq)
    return prof["decoder_layer"]["flops"]
