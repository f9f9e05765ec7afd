"""Placement plans — the paper's per-module state vector P plus device maps.

A :class:`PlacementPlan` tracks, for one LLM instance:

* ``p``        — the paper's parallelism vector P = [p_1..p_n] (replication
  degree per layer; p_i = 1 + number of replicas).
* ``replicas`` — layer -> list of device ids hosting the extra replicas.
* ``migrated`` — (layer, component) -> device id for fine-grained migrations
  (components: "layer", "attn", "ffn", "kv_cache" — §3.3 of the paper).

``continuity_breaks`` is the paper's δ driver: the number of boundaries where
the replica device-set changes between consecutive layers (each boundary
costs one scatter + one all-gather in the dataflow, §3.1/Fig. 4).

Copy of ``repro.core.plan`` for the port: its imports point at
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

COMPONENTS = ("layer", "attn", "ffn", "kv_cache")


@dataclasses.dataclass
class PlacementPlan:
    n_layers: int
    home_device: int = 0
    replicas: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    migrated: Dict[Tuple[int, str], int] = dataclasses.field(
        default_factory=dict)

    # ------------------------------------------------------------------ P
    @property
    def p(self) -> List[int]:
        return [1 + len(self.replicas.get(i, [])) for i in range(self.n_layers)]

    def copy(self) -> "PlacementPlan":
        return PlacementPlan(
            n_layers=self.n_layers,
            home_device=self.home_device,
            replicas={k: list(v) for k, v in self.replicas.items()},
            migrated=dict(self.migrated))

    # ------------------------------------------------------------- editing
    def add_replica(self, layer: int, device: int):
        assert 0 <= layer < self.n_layers
        self.replicas.setdefault(layer, []).append(device)

    def evict_replica(self, layer: int, device: Optional[int] = None):
        reps = self.replicas.get(layer)
        if not reps:
            return False
        if device is None:
            reps.pop()
        elif device in reps:
            reps.remove(device)
        else:
            return False
        if not reps:
            del self.replicas[layer]
        return True

    def migrate(self, layer: int, component: str, device: int):
        assert component in COMPONENTS
        self.migrated[(layer, component)] = device

    # ------------------------------------------------------------- queries
    def device_set(self, layer: int) -> Tuple[int, ...]:
        home = self.migrated.get((layer, "layer"), self.home_device)
        return tuple(sorted([home] + self.replicas.get(layer, [])))

    def continuity_breaks(self) -> int:
        """Boundaries where the replica device-set changes (drives δ)."""
        breaks = 0
        prev = (self.home_device,)
        for i in range(self.n_layers):
            cur = self.device_set(i)
            if cur != prev:
                breaks += 1
            prev = cur
        if prev != (self.home_device,):
            breaks += 1  # gather back at the stack exit
        return breaks

    def replicated_layer_count(self) -> int:
        return sum(1 for i in range(self.n_layers) if len(self.device_set(i)) > 1)

    def devices_used(self) -> Tuple[int, ...]:
        devs = {self.home_device}
        for reps in self.replicas.values():
            devs.update(reps)
        devs.update(self.migrated.values())
        return tuple(sorted(devs))

    def layers_on_device(self, device: int) -> List[int]:
        """Layers with any presence (home/replica/migrated) on ``device``."""
        out = []
        for i in range(self.n_layers):
            if device in self.device_set(i):
                out.append(i)
                continue
            if any(d == device and k[0] == i for k, d in self.migrated.items()):
                out.append(i)
        return out

    @staticmethod
    def initial(n_layers: int, home_device: int = 0) -> "PlacementPlan":
        return PlacementPlan(n_layers=n_layers, home_device=home_device)
