"""Seeded weights in the port's parameter layout, drawn on the device.

The benchmark makes the weights (the program's own ``init_params`` is
not used), hands the same tensors to the program and to the plain
reference, and the reference reads them only layer by layer. The
leaves and their shapes are the layout's (``reference/<name>.py``'s
``shapes``); one ``normal_`` or ``uniform_`` call a leaf, straight into
the served type: an embedding std 1, a matrix std ``1/sqrt(fan-in)``, a
norm scale uniform in [0.8, 1.2]."""
from __future__ import annotations

import math

import torch

from perfbench.reference import layout

#: how the norm scales are drawn: uniform in [1 - s, 1 + s]
NORM_SPREAD = 0.2


def weight_bytes(m: dict, itemsize: int = 2) -> int:
    return sum(math.prod(s) for s, _ in layout(m).shapes(m).values()) \
        * itemsize


def draw(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of the configuration file ``m`` from ``seed``, as a
    nested dict."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    params: dict = {}
    for name, (shape, fan_in) in layout(m).shapes(m).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        if name == "embed":
            t.normal_(0.0, 1.0, generator=gen)
        elif fan_in is None:
            t.uniform_(1.0 - NORM_SPREAD, 1.0 + NORM_SPREAD, generator=gen)
        else:
            t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
        node = params
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return params
