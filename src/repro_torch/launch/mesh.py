"""Production and host meshes of ranks: the port's counterpart of
``repro.launch.mesh``. FUNCTIONS (not module-level constants), so
importing this module touches no device and forms no group.

Each returns THIS rank's ``parallel.mesh.RankMesh``: every rank of the
mesh calls the same function with its own ``rank`` over one shared
``store`` (a ``torch.distributed`` store, e.g. a ``TCPStore``), and the
mesh forms when all of them have joined (``RankMesh.build``: one
process group per axis line, NCCL where each rank has a card of its
own, gloo where the ranks share one or run on the CPU).
``launch/dryrun.py`` takes the same shapes with ``RankMesh.dry``, which
needs no store and no other rank.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.mesh import RankMesh

PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(store, rank: int, device, *,
                         multi_pod: bool = False) -> RankMesh:
    """Rank ``rank`` of the (16, 16) mesh over ("data", "model"), or of
    (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``."""
    shape, axes = PRODUCTION_SHAPE[multi_pod]
    return RankMesh.build(store, axes, shape, rank, device)


def make_host_mesh(store, rank: int, device, n: int = None,
                   axes=("data",)) -> RankMesh:
    """The small mesh of tests and examples: ``n`` ranks on the first of
    ``axes`` (the others of size 1). On a CUDA ``device`` rank r takes
    the card ``cuda:r``, so the groups are NCCL's, as the reference's
    host mesh spans ``jax.devices()[:n]``; ``n`` then defaults to the
    CUDA devices of this host, else to 1."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        device = torch.device("cuda", rank)
    if n is None:
        n = torch.cuda.device_count() if cuda else 1
    shape = (n,) + (1,) * (len(axes) - 1)
    return RankMesh.build(store, tuple(axes), shape, rank, device)
