"""Module replication (§3.1), the part one card runs.

The reference (``repro.core.replication``) realizes a plan's per-layer
replication degrees as batch-sharding constraints over a factorized
replication mesh of power-of-two size. This port keeps its
framework-free half: ``quantize_degrees`` and the size of the
replication group the live engine shards over. On one card, or on the
CPU, that group is one device, every degree quantizes to 1, and a plan
changes nothing in the decode step. The mesh, the per-layer hooks, the
collective count and parameter replication across cards wait for
ROADMAP A10 (``Engine.apply_plan`` raises for a degree above 1 when
more than one card is visible).
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def replication_group_size(device=None) -> int:
    """Devices a live engine on ``device`` replicates over: the largest
    power of two <= the visible CUDA cards; 1 on the CPU."""
    if device is not None and torch.device(device).type != "cuda":
        return 1
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = 1
    while n * 2 <= cards:
        n *= 2
    return n


def quantize_degrees(p: Sequence[int], n_devices: int) -> List[int]:
    """Round each p_i down to the nearest power of two <= n_devices."""
    out = []
    for pi in p:
        q = 1
        while q * 2 <= min(pi, n_devices):
            q *= 2
        out.append(q)
    return out
