"""DENSE KV-cache utilities: capacity planning, byte accounting, slot
updates for the engine's dense path.

PyTorch counterpart of ``repro.serving.kvcache``: how many rows a
request's cache needs (the ring window for sliding-window archs), how
many bytes a token's KV (``kv_bytes_per_token``), a request's O(1)
recurrent state (``state_bytes``) or a whole cache (``cache_bytes``)
takes, and the per-slot insertion and eviction of the dense ``[B,
max_len]`` cache (``models.transformer.init_cache``) that SSM, hybrid,
MLA, audio and sliding-window serving decode against (``Engine(
cache_kind="dense")``). The byte accounting is layout-agnostic; the offline
simulator and the paged engine's pool sizing use it too.

Insertion and eviction write the engine's cache IN PLACE (the reference
rebuilt it functionally), so the tensors a CUDA graph of the dense
decode step reads never move.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.migration import tree_bytes
from repro_torch.models.transformer import BIG_POS


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


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def cache_bytes(cache) -> int:
    return tree_bytes(cache)


def insert_request(cache, slot: int, request_cache, length: int):
    """Insert a single-request (batch=1) prefilled cache into batch
    ``slot`` of ``cache``, in place; returns ``cache``.

    Both caches must come from the same (cfg, max_len). A leaf's batch
    axis is the reference's rule: the first axis where the request leaf
    has size 1 and every other dim lines up — axis 1 of ``[L, B, ...]``
    leaves, axis 2 of the hybrid's ``[nb, every, B, ...]``, axis 0 of
    ``length`` and ``positions``. (With max_batch == 1 the shapes are
    equal and the first size-1 axis wins: the whole leaf belongs to slot
    0, so a full overwrite is right.)
    """
    for path, src in _leaves(request_cache):
        dst = _at(cache, path)
        for ax in range(dst.dim()):
            if src.shape[ax] == 1 and \
                    dst.shape[:ax] == src.shape[:ax] and \
                    dst.shape[ax + 1:] == src.shape[ax + 1:]:
                dst.narrow(ax, slot, 1).copy_(src)
                break
        else:
            raise ValueError(f"cannot align {tuple(src.shape)} into "
                             f"{tuple(dst.shape)}")
    cache["length"][slot].fill_(length)
    if "positions" in cache:
        cache["positions"][slot].copy_(request_cache["positions"][0])
    return cache


def evict_request(cache, slot: int):
    """Reset a slot (request finished), in place: zero length,
    re-poisoned positions. Returns ``cache``. ``fill_`` takes the value
    as a launch argument: an indexed assignment of a Python number would
    copy it from the host and synchronize."""
    cache["length"][slot].fill_(0)
    if "positions" in cache:
        cache["positions"][slot].fill_(BIG_POS)
    return cache

