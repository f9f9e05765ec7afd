"""The H100's peaks and the operations and bytes the served work needs,
counted from shapes and lengths, never from how a kernel does it.

The bound arithmetic is copied from ``chip_smoke.py`` (``least_time_ms``,
``paged_bound_ms``, ``wide_bound``): a piece of work takes at least the
larger of its bytes over the memory rate and its operations over the
input type's peak. Peaks: NVIDIA's H100 SXM data sheet, dense rates."""
from __future__ import annotations

import math
from typing import Iterable

from perfbench.reference import layout

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
BF16 = 2


def _work(m: dict) -> dict:
    """The configuration's sizes, from its layout (``reference/<name>.py``)."""
    return layout(m).work(m)


def layer_weights(m: dict) -> int:
    """Weights of one decoder layer's matrix products."""
    return _work(m)["layer_weights"]


def step_weight_bytes(m: dict) -> int:
    """Bytes of the weights a step reads once: every layer's matrices and
    the head (of the embedding table it reads a row a token)."""
    w = _work(m)
    return (w["layers"] * w["layer_weights"] + w["head_weights"]) * BF16


def kv_bytes_per_token(m: dict) -> int:
    w = _work(m)
    return w["layers"] * w["kv_per_token"] * BF16


def attn_flops(m: dict, n_keys: int) -> int:
    """One query's attention over ``n_keys`` keys, every layer."""
    w = _work(m)
    return w["layers"] * w["attn_flops_per_key"] * n_keys


def decode_flops(m: dict, ctx: int) -> int:
    """A decode row: its token through every layer and the head, and its
    attention over ``ctx`` keys."""
    return 2 * step_weight_bytes(m) // BF16 + attn_flops(m, ctx)


def prefill_flops(m: dict, n: int, start: int) -> int:
    """``n`` prompt tokens computed after ``start`` cached ones: their
    matrix products, their causal attention, and the head once (the
    first token's logits)."""
    w = _work(m)
    keys = n * start + n * (n + 1) // 2
    return (2 * w["layers"] * w["layer_weights"] * n + attn_flops(m, 1) * keys
            + 2 * w["head_weights"])


def least_time_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def paged_decode_bound_s(m: dict, ctxs: Iterable[int], block_size: int) -> float:
    """Least time of one decode step's paged attention, every layer: the
    K and V of every valid block read once, each row's q read and out
    written, the table entries and lengths read; 4 * H * D operations a
    valid key (``chip_smoke.paged_bound_ms``, active rows only)."""
    w = _work(m)
    ctxs = list(ctxs)
    if not ctxs:
        return 0.0
    blocks = sum(-(-c // block_size) for c in ctxs)
    nbytes = (blocks * block_size * w["kv_per_token"] * BF16
              + 2 * len(ctxs) * w["q_per_token"] * BF16 + blocks * 4
              + len(ctxs) * 4)
    flops = w["attn_flops_per_key"] * sum(ctxs)
    return w["layers"] * least_time_s(nbytes, flops)


def mean(xs) -> float:
    xs = list(xs)
    return math.fsum(xs) / len(xs) if xs else 0.0
