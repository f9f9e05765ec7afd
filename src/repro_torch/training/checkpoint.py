"""Checkpointing: a tensor tree <-> msgpack on disk, in the reference's
file format.

PyTorch counterpart of ``repro.training.checkpoint``. One file holds a
msgpack map of ``"a/b/c"`` paths (the keys of the nested dict, sorted at
every level, as ``jax.tree_util.tree_flatten_with_path`` names them),
each ``{"dtype", "shape", "data"}`` with the leaf's raw bytes, plus
``"__meta__"``; it is written to ``<path>.tmp`` and moved into place.
numpy has no bf16, so a bf16 leaf is written as its raw bits (a uint16
view) under the dtype name ``"bfloat16"``, the bytes the reference writes
for its bf16 arrays, and read back through ``np.uint16``. A checkpoint
written by either package loads into the other bit for bit.
"""
from __future__ import annotations

import os

import msgpack
import numpy as np
import torch

from repro_torch.training import optimizer as OPT


def _flatten(tree):
    """{"a/b/c": leaf} in the reference's order."""
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in OPT.tree_items(tree)}


def _entry(t: torch.Tensor) -> dict:
    """A leaf's entry; ``data`` is a byte view of its host copy (msgpack
    writes it as the bytes ``tobytes`` would give, without the copy)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        arr, name = t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    else:
        arr = t.numpy()
        name = str(arr.dtype)
    return {"dtype": name, "shape": list(arr.shape),
            "data": memoryview(arr.reshape(-1)).cast("B")}


def _tensor(entry: dict) -> torch.Tensor:
    """A CPU tensor of one entry's bytes (a copy: the buffer is the
    unpacked file's)."""
    if entry["dtype"] == "bfloat16":
        bits = np.frombuffer(entry["data"], dtype=np.uint16)
        return torch.from_numpy(bits.view(np.int16).reshape(
            entry["shape"]).copy()).view(torch.bfloat16)
    arr = np.frombuffer(entry["data"], dtype=entry["dtype"])
    return torch.from_numpy(arr.reshape(entry["shape"]).copy())


def save(path: str, tree, meta: dict | None = None):
    """Write ``tree`` and ``meta``. The map is written pair by pair (the
    bytes of ``msgpack.packb`` of the whole map, as the reference writes
    it), so one leaf's host copy is alive at a time."""
    flat = _flatten(tree)
    packer = msgpack.Packer(use_bin_type=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packer.pack_map_header(len(flat) + 1))
        f.write(packer.pack("__meta__"))
        f.write(packer.pack(meta or {}))
        for k, v in flat.items():
            f.write(packer.pack(k))
            f.write(packer.pack(_entry(v)))
    os.replace(tmp, path)


def load(path: str, like=None):
    """Load a checkpoint: ``(tree, meta)``. With ``like`` (a template
    tree), the tree has its structure, and each leaf its template's dtype
    and device (converted by value, as the reference converts); without
    it, a flat ``{"a/b/c": CPU tensor}`` in the stored dtypes."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    meta = payload.pop("__meta__", {})
    arrays = {k: _tensor(v) for k, v in payload.items()}
    if like is None:
        return arrays, meta
    flat_like = _flatten(like)
    missing = set(flat_like) - set(arrays)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    paths = [path for path, _ in OPT.tree_items(like)]
    leaves = [arrays[k].to(device=leaf.device, dtype=leaf.dtype)
              for k, leaf in flat_like.items()]
    return OPT.tree_from(paths, leaves), meta
