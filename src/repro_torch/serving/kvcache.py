"""KV-cache byte accounting and capacity planning.

Copy of the pure functions of ``repro.serving.kvcache``: how many rows a
request's cache needs (the ring window for sliding-window archs), and how
many bytes a token's KV (``kv_bytes_per_token``) or a request's O(1)
recurrent state (``state_bytes``) takes. The byte accounting is
layout-agnostic; the offline simulator (``serving/simulator.py``) and the
paged engine's pool sizing use it.

The dense cache's per-slot ``insert_request`` / ``evict_request`` (and
``cache_bytes``) wait for the dense-cache engine (ROADMAP A9.1).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def cache_capacity(cfg: ModelConfig, logical_len: int, *, swa: bool = False):
    """Rows to allocate per request: full length, or the ring window."""
    if swa and cfg.sliding_window:
        return min(logical_len, cfg.sliding_window)
    return logical_len


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Per-token per-request KV bytes across all layers (Table 1 analysis)."""
    if cfg.family == "ssm":
        return 0  # O(1) state, no per-token growth
    hd = cfg.resolved_head_dim
    if cfg.attention_kind == "mla":
        per_layer = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        per_layer = 2 * cfg.num_kv_heads * hd
    if cfg.family == "hybrid":
        nb = cfg.num_layers // cfg.hybrid_attn_every
        return nb * 2 * cfg.num_kv_heads * hd * dtype_bytes
    n = cfg.num_layers
    return n * per_layer * dtype_bytes


def state_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """O(1) recurrent-state bytes per request (SSM/hybrid archs)."""
    if cfg.ssm_state == 0:
        return 0
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    ch = cfg.ssm_d_inner + 2 * cfg.ssm_ngroups * N
    per_layer = (cfg.ssm_conv_dim - 1) * ch + cfg.ssm_heads * P * N
    return cfg.num_layers * per_layer * dtype_bytes
