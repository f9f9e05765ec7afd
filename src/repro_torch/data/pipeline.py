"""Synthetic tokenized data pipeline.

PyTorch counterpart of ``repro.data.pipeline``: a deterministic token
stream shaped like a packed LM dataset (documents separated by an EOS
id, next-token labels, a loss mask), drawn from the same numpy
``default_rng`` stream as the reference, so a batch is bit-identical to
the reference's. ``sharded_batches`` gives one rank of a mesh its rows
of each batch, as the reference's places a batch on its mesh, with an
audio config's stand-in encoder frames (``synth_frames``) where asked.

The draws are numpy, so a batch is the same bits on every device. Each
function puts its tensors on the card unless the caller passes
``device="cpu"``; without CUDA and without a device it raises, as the
engine does.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import shard_leaf


def _device(device):
    """``device``, or the card where the caller names none (raising
    without CUDA)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to draw the "
                           "batches on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    eos_id: int = 1
    mean_doc_len: int = 384


def synth_batch(cfg: ModelConfig, dcfg: DataConfig, step: int,
                device=None) -> dict:
    """One packed batch on ``device``: ``tokens`` and ``labels`` int32
    [B, S], ``mask`` float32 [B, S] (0 where the label is the EOS id)."""
    rng = np.random.default_rng(dcfg.seed * 1_000_003 + step)
    B, S = dcfg.global_batch, dcfg.seq_len
    toks = rng.integers(2, cfg.vocab_size, size=(B, S + 1), dtype=np.int64)
    # sprinkle EOS boundaries to emulate packed documents
    n_eos = max(1, (S + 1) // dcfg.mean_doc_len)
    for b in range(B):
        pos = rng.integers(1, S, size=n_eos)
        toks[b, pos] = dcfg.eos_id
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    mask = (labels != dcfg.eos_id).astype(np.float32)
    device = _device(device)
    return {k: torch.from_numpy(v).to(device)
            for k, v in (("tokens", tokens), ("labels", labels),
                         ("mask", mask))}


def synth_frames(cfg: ModelConfig, dcfg: DataConfig, step: int,
                 device=None) -> torch.Tensor:
    """Stand-in encoder frames of batch ``step`` for an audio config:
    float32 [B, encoder_seq_len, d_model], standard normal from numpy's
    ``default_rng`` on a stream of their own (the reference's
    ``launch/train.py`` trains on zero frames; distinct rows show each
    rank's part)."""
    rng = np.random.default_rng([dcfg.seed, step, 1])
    shape = (dcfg.global_batch, cfg.encoder_seq_len, cfg.d_model)
    return torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(_device(device))


def batches(cfg: ModelConfig, dcfg: DataConfig,
            num_steps: Optional[int] = None, device=None) -> Iterator[dict]:
    device = _device(device)
    step = 0
    while num_steps is None or step < num_steps:
        yield synth_batch(cfg, dcfg, step, device)
        step += 1


def sharded_batches(cfg: ModelConfig, dcfg: DataConfig, mesh, batch_spec,
                    num_steps: Optional[int] = None,
                    frames: bool = False) -> Iterator[dict]:
    """This rank's part of each ``synth_batch`` global batch under
    ``batch_spec`` (a spec tuple, e.g. ``("data", None)``, the reference's
    ``PartitionSpec`` applied to every leaf) on ``mesh`` (a
    ``parallel.mesh.RankMesh``), on the mesh's device: the rows of the
    row-major split over the batch axes (``mesh.axes_index``). A dim that
    does not divide raises, as a ``NamedSharding`` would. ``frames``
    adds the batch's ``synth_frames`` under ``"frames"``, split by rows
    alike (the reference's ``batch_specs(with_frames=True)``). The
    global batch is drawn on the CPU and only this rank's rows move."""
    for step, b in enumerate(batches(cfg, dcfg, num_steps, device="cpu")):
        if frames:
            b["frames"] = synth_frames(cfg, dcfg, step, device="cpu")
        yield {k: shard_leaf(v, batch_spec, mesh).to(mesh.device)
               for k, v in b.items()}
