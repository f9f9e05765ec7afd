"""Weight bridge: the JAX ``init_params`` pytree (and an optimizer
state), as numpy, to the port's parameter dict.

The caller converts the JAX tree with ``jax.tree_util.tree_map(np.asarray,
tree)``; this module takes only numpy, so it never imports JAX. Keys and
the stacked ``[L, ...]`` layout are kept one for one, so a parameter is
found under the same path in both packages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.parallel import sharding as SH


def _tensor(a: np.ndarray, device, dtype: Optional[torch.dtype]):
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16 (ml_dtypes supplies it): widening to
        # float32 and narrowing back in torch is exact
        t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Map a nested dict of numpy arrays to the same nested dict of
    tensors on ``device``. ``dtype`` (optional) casts every floating
    leaf; without it each leaf keeps its own type."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _tensor(np.asarray(tree), device, dtype)


def opt_state_from_numpy(state, device):
    """A JAX optimizer state (``repro.training.optimizer.init_opt_state``'s
    tree as numpy: ``step``, ``mu``, ``nu``) as the port's: ``step`` an
    int32 0-d tensor, the moments in their own types, on ``device``."""
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device),
            "mu": params_from_numpy(state["mu"], device),
            "nu": params_from_numpy(state["nu"], device)}


def shard_from_numpy(tree, specs, mesh, device,
                     dtype: Optional[torch.dtype] = None):
    """This rank's shard of a numpy params tree: each leaf sliced by its
    spec on ``mesh`` (``parallel.sharding.shard_params``), then made a
    tensor as ``params_from_numpy`` makes it."""
    return params_from_numpy(SH.shard_params(tree, specs, mesh), device,
                             dtype)
