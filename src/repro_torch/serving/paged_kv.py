"""Paged KV cache — the block-table pool behind the Engine's decode path.

PyTorch counterpart of ``repro.serving.paged_kv``. The host bookkeeping
(free list, refcounts, prefix cache with its LRU ``cached_free`` list,
write epochs, scatter plans) is numpy and mirrors the reference line for
line; torch owns the device side: the pool tensors, the copy-on-write
block copy, the pool scatter, and the gathers.

Layout: a global pool of fixed-size blocks per layer, stored
KV-HEAD-MAJOR — ``k/v: [L, n_blocks, KV, bs, hd]`` — so each (block,
kv-head) pair is a contiguous ``[bs, hd]`` tile, the tile the decode
kernel (kernels/paged_decode.py) reads per loop step. A per-request block
table ``[B, max_blocks]`` of pool indices (-1 = unallocated) maps absolute
token position ``p`` to table column ``p // block_size``.

Ownership model (prefix sharing / copy-on-write): every block carries a
REFERENCE COUNT and is in one of four states — free (refcount 0, on
``free``), owned (refcount 1), shared (refcount > 1, read-only; a writer
forks it first with ``ensure_writable``) or cached-free (refcount 0 but
holding a registered full prompt block, on the LRU ``cached_free`` list,
revivable by a later ``match_prefix`` hit and evicted only under
allocation pressure). The prefix cache keys FULL prompt blocks by a
content chain hash (``_chain_keys``), byte-identical to the reference's.

Pool writes are IN PLACE (``index_put_``) where the reference rebuilt the
pool functionally. The reference's ``mode="drop"`` scatters push pad rows
and holes to the out-of-range block ``n_blocks``; here the pool tensors
hold one more block, the SCRATCH block at index ``n_blocks``, and the
dropped rows land there (on the card an out-of-range index corrupts
memory or traps). So every write has a fixed shape, as a CUDA graph
needs. Nothing reads the scratch block: no block table holds its index,
and allocation, ``pool_bytes``, ``utilization`` and export/import see the
``n_blocks`` real blocks only. Many dropped rows may share a scratch
index (torch leaves the order of duplicate index writes undefined, which
is harmless there); a dropped row never shares an index with a live row.

Migration wire format (``export_blocks`` / ``import_blocks`` /
``import_blocks_delta``): the reference's, host arrays of numpy. An
export is one ``index_select`` over the pool's block axis and ONE
device→host copy per array (``instrument.fetch``), finished before the
caller frees the source blocks; an import is one host→device copy per
array (``instrument.upload``) and an in-place ``index_copy_``. numpy has
no bf16, so a bf16 pool's blocks travel on one of two wires
(``export_blocks(wire=...)``): ``"bits"`` (the default, between port
engines) ships their raw bits, ``np.uint16``, tagged ``"kv_dtype":
"bfloat16"``; ``"float32"`` ships them widened to float32 with no tag,
for a peer that does not read the tag (the reference's ``import_blocks``
converts by value). bf16 -> float32 -> bf16 is exact; the float32 wire
ships twice the bytes, and ``nbytes`` counts the bytes shipped. An import
reads either, a float16 array, or one of a numpy dtype named
``bfloat16`` (the reference's export of a bf16 pool), without importing
that dtype's package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import to_device, torch_dtype
from repro_torch.serving.instrument import bits_checksum, fetch, upload


@dataclasses.dataclass
class PagedState:
    """Device pool tensors + host-side free list / refcounts for one engine.

    Invariants (asserted by tests/test_torch_paged_kv.py):

    * ``refcount[b] == 0``  iff  ``b`` is on ``free`` or ``cached_free``;
    * ``refcount[b]`` equals the number of block-table cells holding ``b``;
    * ``block_key[b] == key`` iff ``prefix_cache[key] == b`` (a bijection
      over registered blocks);
    * blocks on ``free`` are never registered; blocks on ``cached_free``
      always are (their cache entry is dropped when they are evicted).
    """
    k: torch.Tensor           # [L, n_blocks + 1, KV, bs, hd] (KV-head-
    v: torch.Tensor           # major; the last block is the scratch block)
    block_tables: np.ndarray  # [B, max_blocks] int32 host array (-1 empty)
    lengths: np.ndarray       # [B] int32 host array
    free: List[int]
    block_size: int
    # --- prefix sharing / copy-on-write ---
    refcount: Optional[np.ndarray] = None     # [n_blocks] int32
    enable_prefix_cache: bool = False
    prefix_cache: Dict[bytes, int] = dataclasses.field(default_factory=dict)
    block_key: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    cached_free: "OrderedDict[int, None]" = \
        dataclasses.field(default_factory=OrderedDict)
    # --- dirty set for overlapped (two-phase) migration ---
    write_epoch: int = 0                       # bumps once per pool write
    block_epoch: Optional[np.ndarray] = None   # [n_blocks] int64 last write
    # --- counters (prefix-sharing gauges) ---
    prefix_queries: int = 0       # full prompt blocks looked up
    prefix_hits: int = 0          # ... of which aliased an existing block
    cow_forks: int = 0            # copy-on-write block copies performed
    blocks_saved_total: int = 0   # cumulative allocations avoided by hits
    dedup_imports: int = 0        # imported blocks aliased to residents

    def __post_init__(self):
        if self.refcount is None:     # direct constructions (tests, tools)
            self.refcount = np.zeros((self.n_blocks,), np.int32)
        if self.block_epoch is None:
            self.block_epoch = np.zeros((self.n_blocks,), np.int64)

    @property
    def n_blocks(self) -> int:
        """Real blocks: the pool tensors' block axis less the scratch
        block."""
        return self.k.shape[1] - 1

    def free_block_count(self) -> int:
        """Blocks allocatable right now: the plain free list plus the
        cached-free blocks that allocation pressure may evict."""
        return len(self.free) + len(self.cached_free)

    def blocks_in_use(self) -> int:
        return self.n_blocks - self.free_block_count()

    def shared_blocks_saved(self) -> int:
        """Physical blocks the pool is saving RIGHT NOW through sharing:
        each block referenced r > 1 times stands in for r - 1 copies."""
        return int(np.maximum(self.refcount - 1, 0).sum())

    def pool_bytes(self) -> int:
        """Bytes of the real blocks (the scratch block left out)."""
        per_block = self.k[:, 0].numel() * self.k.element_size()
        return int(2 * per_block * self.n_blocks)

    def utilization(self) -> float:
        """Fraction of allocated slots actually holding tokens (1 - frag),
        capped at 1 (windowed requests count absolute ``lengths``; shared
        blocks serve several requests' tokens at once)."""
        used_blocks = self.blocks_in_use()
        if used_blocks == 0:
            return 1.0
        toks = int(self.lengths.sum())
        return min(1.0, toks / (used_blocks * self.block_size))


def init_paged(cfg: ModelConfig, max_batch: int, n_blocks: int,
               block_size: int = 16, dtype="bfloat16",
               max_len: int = 4096, prefix_cache: bool = False,
               device="cuda", kv_heads: Optional[int] = None) -> PagedState:
    """Build a pool of ``n_blocks`` blocks (and the scratch block) on
    ``device``. ``prefix_cache=True`` enables prompt-prefix sharing (the
    Engine turns it on by default). ``kv_heads``: the KV heads the pool
    holds (default every one of ``cfg``'s; ``init_paged_shard``)."""
    dtype = torch_dtype(dtype)
    hd = cfg.resolved_head_dim
    L, KV = cfg.num_layers, kv_heads or cfg.num_kv_heads
    max_blocks = -(-max_len // block_size)
    shape = (L, n_blocks + 1, KV, block_size, hd)
    return PagedState(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=np.full((max_batch, max_blocks), -1, np.int32),
        lengths=np.zeros((max_batch,), np.int32),
        free=list(range(n_blocks)), block_size=block_size,
        refcount=np.zeros((n_blocks,), np.int32),
        enable_prefix_cache=prefix_cache)


def init_paged_shard(cfg: ModelConfig, max_batch: int, n_blocks: int, rules,
                     mesh, **kw) -> PagedState:
    """One rank's pool under sharding rules (``forward_paged``'s): its
    rows of ``max_batch`` under ``rules["batch"]`` and its own
    ``n_blocks`` blocks (and scratch block) for them, at its KV heads
    where ``rules["kv_heads"]`` splits them, else at every KV head. It
    is allocated at that local shape, the whole pool never made. The
    reference's ``cache_specs`` has no paged entry, so no rule splits a
    pool over its blocks (``cache_seq`` does not apply). ``kw`` are
    ``init_paged``'s."""
    n_rows = mesh.axes_size(rules.get("batch"))
    n_kv = mesh.axes_size(rules.get("kv_heads"))
    if max_batch % n_rows or cfg.num_kv_heads % n_kv:
        raise ValueError(f"{max_batch} rows and {cfg.num_kv_heads} KV heads "
                         f"do not split {n_rows} and {n_kv} ways")
    return init_paged(cfg, max_batch // n_rows, n_blocks,
                      kv_heads=cfg.num_kv_heads // n_kv, **kw)


class OutOfBlocks(RuntimeError):
    pass


# ----------------------------------------------------- refcount primitives
def _pop_block(state: PagedState) -> int:
    """Take a refcount-0 block for a new owner: plain free list first,
    then the OLDEST cached-free block (its prefix-cache entry is evicted
    — LRU under allocation pressure). Raises OutOfBlocks, mutating
    nothing, when neither has one."""
    if state.free:
        return state.free.pop()
    if state.cached_free:
        b = next(iter(state.cached_free))
        del state.cached_free[b]
        key = state.block_key.pop(b)
        state.prefix_cache.pop(key, None)
        return b
    raise OutOfBlocks("pool exhausted: no free or cached-free blocks")


def _incref(state: PagedState, b: int):
    if int(state.refcount[b]) == 0:
        # reviving a cached-free block: content stays valid, it just
        # leaves the evictable list
        state.cached_free.pop(b, None)
    state.refcount[b] += 1


def _decref(state: PagedState, b: int):
    state.refcount[b] -= 1
    if state.refcount[b] < 0:
        raise AssertionError(f"refcount underflow on block {b}")
    if state.refcount[b] == 0:
        if b in state.block_key:        # registered: stay revivable
            state.cached_free[b] = None  # most-recently-freed = LRU tail
        else:
            state.free.append(b)


def mark_written(state: PagedState, block_ids) -> int:
    """Stamp ``block_ids`` as written at a fresh ``write_epoch`` (the
    dirty-set bookkeeping behind two-phase migration). Returns the new
    epoch."""
    state.write_epoch += 1
    ids = [int(b) for b in block_ids if 0 <= int(b) < state.n_blocks]
    if ids:
        state.block_epoch[ids] = state.write_epoch
    return state.write_epoch


# -------------------------------------------------------------- allocation
def allocate(state: PagedState, slot: int, n_tokens: int,
             window: Optional[int] = None):
    """Ensure ``slot`` has blocks for lengths[slot] + n_tokens tokens.

    Fresh blocks come out OWNED (refcount 1) by ``slot``. Column-indexed:
    only the columns the new tokens land in are allocated; with
    ``window``, columns already fully out of the attention window after
    the write are never allocated. Raises OutOfBlocks — WITHOUT mutating
    any state — when the pool has too few free blocks or the needed
    column exceeds the table row."""
    if n_tokens <= 0:
        return
    bs = state.block_size
    start = int(state.lengths[slot])
    first_col = start // bs
    last_col = (start + n_tokens - 1) // bs
    if window is not None:
        dead = (start + n_tokens - window + 1) // bs
        first_col = max(first_col, min(dead, last_col))
    if last_col >= state.block_tables.shape[1]:
        raise OutOfBlocks(
            f"slot {slot} block table full: needs column {last_col}, "
            f"table holds {state.block_tables.shape[1]}")
    missing = [c for c in range(first_col, last_col + 1)
               if state.block_tables[slot, c] < 0]
    if len(missing) > state.free_block_count():
        raise OutOfBlocks(
            f"need {len(missing)} blocks, {state.free_block_count()} free")
    for c in missing:
        b = _pop_block(state)
        state.refcount[b] = 1
        state.block_tables[slot, c] = b


def free_slot(state: PagedState, slot: int):
    """Release ``slot``'s claim on every block it holds (DECREF, not
    unconditional free)."""
    for b in state.block_tables[slot]:
        if b >= 0:
            _decref(state, int(b))
    state.block_tables[slot] = -1
    state.lengths[slot] = 0


def free_out_of_window(state: PagedState, slot: int, window: int) -> int:
    """Sliding-window reclamation: release (decref) the leading blocks of
    ``slot`` whose every token has fallen out of the attention window;
    they become holes (-1). The backward scan stops at the first hole.
    Returns #blocks this slot released."""
    bs = state.block_size
    n_dead = min(max((int(state.lengths[slot]) - window + 1) // bs, 0),
                 state.block_tables.shape[1])
    freed = 0
    for c in range(n_dead - 1, -1, -1):
        b = int(state.block_tables[slot, c])
        if b < 0:
            break
        _decref(state, b)
        state.block_tables[slot, c] = -1
        freed += 1
    return freed


# ----------------------------------------------------------- prefix cache
def _chain_keys(tokens, block_size: int) -> List[bytes]:
    """Content chain hash of every FULL block of ``tokens``: key_c =
    H(key_{c-1} || tokens[c*bs:(c+1)*bs]). Must stay byte-identical to
    the reference's: the router keys on it."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    keys, h = [], b""
    for c in range(len(toks) // block_size):
        h = hashlib.sha1(
            h + toks[c * block_size:(c + 1) * block_size].tobytes()).digest()
        keys.append(h)
    return keys


def match_prefix(state: PagedState, tokens, *,
                 record: bool = True) -> List[int]:
    """Longest cached prefix of ``tokens``: the pool block ids (in column
    order) of the leading FULL blocks whose content chain is registered.
    ``record=False`` skips the hit/query counters (the engine records
    once per admitted request via ``record_lookup``)."""
    if not state.enable_prefix_cache:
        return []
    keys = _chain_keys(tokens, state.block_size)
    if not keys:
        return []
    out: List[int] = []
    for key in keys:
        b = state.prefix_cache.get(key)
        if b is None:
            break
        out.append(b)
    if record:
        state.prefix_queries += len(keys)
        state.prefix_hits += len(out)
    return out


def record_lookup(state: PagedState, tokens, matched: Sequence[int]):
    """Count one prefix-cache lookup in the hit-rate gauges."""
    state.prefix_queries += len(tokens) // state.block_size
    state.prefix_hits += len(matched)
    state.blocks_saved_total += len(matched)


def adopt_prefix(state: PagedState, slot: int, block_ids: Sequence[int],
                 n_tokens: int):
    """Alias a matched prefix into ``slot``: INCREF each block and bind it
    at its column; ``slot`` then holds ``n_tokens`` of context. Requires
    an empty slot row at those columns."""
    if n_tokens > len(block_ids) * state.block_size:
        raise ValueError(f"{n_tokens} tokens exceed the adopted blocks")
    for c, b in enumerate(block_ids):
        if state.block_tables[slot, c] >= 0:
            raise ValueError(f"adopt into occupied column {c} of slot {slot}")
        _incref(state, int(b))
        state.block_tables[slot, c] = int(b)
    state.lengths[slot] = n_tokens


def register_prefix(state: PagedState, slot: int, tokens) -> int:
    """Publish ``slot``'s FULL, fully-written blocks into the prefix
    cache. First binding of a key wins; partial tail blocks and window
    holes are skipped. Returns the number of newly registered blocks."""
    if not state.enable_prefix_cache:
        return 0
    n = 0
    for c, key in enumerate(_chain_keys(tokens, state.block_size)):
        b = int(state.block_tables[slot, c])
        if b < 0 or key in state.prefix_cache or b in state.block_key:
            continue
        state.prefix_cache[key] = b
        state.block_key[b] = key
        n += 1
    return n


def ensure_writable(state: PagedState, slot: int, start: int,
                    n_tokens: int) -> int:
    """Copy-on-write: fork every SHARED block that the write of
    ``n_tokens`` tokens at position ``start`` would touch — a fresh block
    (OutOfBlocks if none, the failing column untouched), a device copy of
    the shared block's content, the column rebound, the original
    decref'd. Owned blocks pass through. Returns the number of forks."""
    if n_tokens <= 0:
        return 0
    bs = state.block_size
    pairs = []              # (shared src block, private dst block)
    try:
        for c in range(start // bs, (start + n_tokens - 1) // bs + 1):
            if c >= state.block_tables.shape[1]:
                break
            b = int(state.block_tables[slot, c])
            if b < 0 or int(state.refcount[b]) <= 1:
                continue
            nb = _pop_block(state)
            state.refcount[nb] = 1
            state.refcount[b] -= 1  # still >= 1: other holders keep it
            state.block_tables[slot, c] = nb
            state.cow_forks += 1
            pairs.append((b, nb))
    finally:
        # ONE batched copy for all forks; the finally keeps already-
        # rebound columns backed by real content even when a later
        # column's pop raises
        if pairs:
            dev = state.k.device
            src = to_device(np.asarray([p[0] for p in pairs], np.int64), dev)
            dst = to_device(np.asarray([p[1] for p in pairs], np.int64), dev)
            state.k[:, dst] = state.k[:, src]
            state.v[:, dst] = state.v[:, src]
            mark_written(state, [p[1] for p in pairs])
    return len(pairs)


def prefix_stats(state: PagedState) -> Dict:
    """The pool's sharing gauges (engine telemetry)."""
    q = state.prefix_queries
    return {"queries": q, "hits": state.prefix_hits,
            "hit_rate": state.prefix_hits / q if q else 0.0,
            "cow_forks": state.cow_forks,
            "blocks_saved_total": state.blocks_saved_total,
            "blocks_saved_now": state.shared_blocks_saved(),
            "dedup_imports": state.dedup_imports,
            "cached_blocks": len(state.prefix_cache)}


# ------------------------------------------------------------- pool writes
def write_tokens(state: PagedState, slot: int, k_new, v_new):
    """Append k/v for S new tokens of one request (k_new/v_new:
    [L, S, KV, hd]). Requires allocate() first."""
    return write_tokens_batch(state, [slot], k_new[:, None], v_new[:, None])


def scatter_plan(state: PagedState, slots, S: int,
                 lengths: Optional[Sequence[int]] = None):
    """Host half of a batched S-token append for G slots: per-token
    (block, offset) scatter indices, flattened [G*S]. Pad positions
    (``>= lengths[i]``) and unallocated columns point at block
    ``n_blocks`` (the reference's drop index; here the scratch block).
    ADVANCES ``state.lengths`` and stamps the write epoch — callers must
    execute the device scatter they planned."""
    bs = state.block_size
    if lengths is None:
        lengths = [S] * len(slots)
    n_pool = state.n_blocks
    max_col = state.block_tables.shape[1] - 1
    blocks, offs = [], []
    for slot, n in zip(slots, lengths):
        start = int(state.lengths[slot])
        pos = np.arange(start, start + S)
        cols = np.minimum(pos // bs, max_col)
        blk = state.block_tables[slot, cols]
        blk = np.where((np.arange(S) < n) & (blk >= 0), blk, n_pool)
        blocks.append(blk)
        offs.append(pos % bs)
        state.lengths[slot] = start + n
    bidx = np.concatenate(blocks)
    mark_written(state, np.unique(bidx))
    return bidx, np.concatenate(offs)


def scatter_rows(pool_k, pool_v, bidx, oidx, k_rows, v_rows):
    """Write N token rows into the pool in place, at a fixed shape:
    ``k_rows``/``v_rows`` [L, N, KV, hd] land at blocks ``bidx`` and
    offsets ``oidx`` ([N] long tensors on the pool's device); dropped rows
    carry the scratch block's index. Shared by ``write_tokens_batch`` and
    the engine's chunk prefill."""
    # pool is [L, n_blocks + 1, KV, bs, hd]: advanced indices at axes 1
    # and 3 move to the front, so updates are laid out [N, L, KV, hd]
    pool_k[:, bidx, :, oidx] = k_rows.transpose(0, 1).to(pool_k.dtype)
    pool_v[:, bidx, :, oidx] = v_rows.transpose(0, 1).to(pool_v.dtype)


def write_tokens_batch(state: PagedState, slots, k_new, v_new,
                       lengths: Optional[Sequence[int]] = None):
    """Append k/v for up to S new tokens of G requests in ONE pool write.

    k_new/v_new: [L, G, S, KV, hd] — S is the (possibly padded) group
    length; ``lengths`` gives each request's TRUE new-token count (default
    S for all). Pad positions land in the scratch block. Requires
    allocate() first, and every written column must be OWNED by its slot
    (the engine forks shared columns via ``ensure_writable`` before).
    Writes the pool in place and returns ``state``.
    """
    L, G, S = k_new.shape[:3]
    bidx, oidx = scatter_plan(state, slots, S, lengths)
    dev = state.k.device
    scatter_rows(state.k, state.v, to_device(bidx.astype(np.int64), dev),
                 to_device(oidx.astype(np.int64), dev),
                 k_new.reshape(L, G * S, *k_new.shape[3:]),
                 v_new.reshape(L, G * S, *v_new.shape[3:]))
    return state


# --------------------------------------------------- migration wire format
WIRES = ("bits", "float32")


def _to_wire(t: torch.Tensor, wire: str = "bits"):
    """Pool blocks as a finished host array: (array, dtype tag). On the
    ``"bits"`` wire bf16 travels as its raw bits (``np.uint16``) under
    the tag "bfloat16"; on the ``"float32"`` wire every pool type
    travels as float32, untagged."""
    if wire not in WIRES:
        raise ValueError(f"unknown migration wire {wire!r} (one of {WIRES})")
    if wire == "float32":
        return fetch(t.float()), None
    if t.dtype == torch.bfloat16:
        return fetch(t.view(torch.int16)).view(np.uint16), "bfloat16"
    return fetch(t), None


def _from_wire(a, tag, dtype, device) -> torch.Tensor:
    """A payload array on ``device`` in the pool's ``dtype``: tagged bf16
    bits, a numpy dtype named ``bfloat16`` (read as its bits), or a plain
    float array."""
    a = np.asarray(a)
    if tag == "bfloat16" or a.dtype.name == "bfloat16":
        t = upload(np.ascontiguousarray(a).view(np.int16), device)
        t = t.view(torch.bfloat16)
    else:
        t = upload(np.ascontiguousarray(a), device)
    return t.to(dtype)


def export_blocks(state: PagedState, slot: int,
                  since_epoch: Optional[int] = None,
                  wire: str = "bits") -> Dict:
    """Serialize one request's KV to the block-granular migration wire
    format: the live block-table COLUMNS (absolute position //
    block_size; sliding-window holes are preserved), the pool blocks at
    those columns as host arrays ``[L, n, KV, bs, hd]``, the token
    count, and — for prefix-registered blocks — their content-chain
    ``keys`` (hex, per column) so the destination can re-seed its own
    prefix cache. SHARED blocks are materialized: refcounts never cross
    pools, so the payload is self-contained. Does NOT free or decref the
    source blocks; the arrays are finished host copies, so the caller may
    ``free_slot`` (and the next step overwrite the blocks) right after.

    ``since_epoch`` selects the DELTA wire format: only columns whose
    current block was written after that epoch are shipped. The payload's
    ``epoch`` is the pool's write epoch at export time. ``wire`` picks
    how the block arrays travel (module docstring): ``"bits"`` for a port
    peer, ``"float32"`` for a peer that converts arrays by value."""
    cols = np.nonzero(state.block_tables[slot] >= 0)[0].astype(np.int32)
    if since_epoch is not None and len(cols):
        ids_np = state.block_tables[slot, cols]
        dirty = state.block_epoch[ids_np] > since_epoch
        cols = cols[dirty]
    ids = upload(state.block_tables[slot, cols].astype(np.int64),
                 state.k.device)
    k, tag = _to_wire(state.k.index_select(1, ids), wire)  # [L,n,KV,bs,hd]
    v, _ = _to_wire(state.v.index_select(1, ids), wire)
    keys = {}
    for c in cols:
        b = int(state.block_tables[slot, c])
        if b in state.block_key:
            keys[int(c)] = state.block_key[b].hex()
    payload = {"cols": cols, "k": k, "v": v,
               "length": int(state.lengths[slot]),
               "block_size": state.block_size,
               "keys": keys,
               "epoch": state.write_epoch,
               "nbytes": int(k.nbytes + v.nbytes)}
    if tag is not None:
        payload["kv_dtype"] = tag
    return payload


def read_back(state: PagedState, slot: int, payload: Dict
              ) -> Optional[str]:
    """Read the blocks an import wrote into ``slot`` at the payload's
    columns back from the pool and hold them bit for bit against the
    payload's arrays; a column that aliases a resident block (a shared
    block, ``import_blocks``' dedupe) is left out. Returns the sha256 of
    the blocks read, or None where the payload is untagged float32 for a
    pool of another type (a JAX peer's wire, converted by value). Raises
    ValueError where a block differs."""
    k_pay, v_pay = np.asarray(payload["k"]), np.asarray(payload["v"])
    tagged = payload.get("kv_dtype") is not None
    if not tagged and state.k.dtype != torch.float32:
        return None
    cols = np.asarray(payload["cols"], np.int64)
    ids = state.block_tables[slot, cols].astype(np.int64)
    own = np.asarray([int(state.refcount[b]) == 1 for b in ids], bool)
    h = hashlib.sha256()
    if own.any():
        idx = upload(ids[own], state.k.device)
        for pool, pay, name in ((state.k, k_pay, "k"),
                                (state.v, v_pay, "v")):
            got, _ = _to_wire(pool.index_select(1, idx))
            want = np.ascontiguousarray(pay[:, own])
            if got.shape != want.shape or \
                    got.tobytes() != want.tobytes():
                raise ValueError(
                    f"slot {slot}: the {name} blocks read back at columns "
                    f"{cols[own].tolist()} differ from the payload's")
            h.update(got.tobytes())
    return h.hexdigest()


def pool_checksum(state: PagedState) -> list:
    """``instrument.bits_checksum`` of the pool's K and V over its real
    blocks (the scratch block left out): equal pools give equal sums."""
    nb = state.n_blocks
    return (bits_checksum(state.k[:, :nb].contiguous())
            + bits_checksum(state.v[:, :nb].contiguous()))


def _write_blocks(state: PagedState, ids, payload: Dict, sel=None):
    """Copy the payload's blocks (all, or the indices ``sel``) into pool
    blocks ``ids`` in place and stamp them written."""
    dev = state.k.device
    tag = payload.get("kv_dtype")
    k, v = np.asarray(payload["k"]), np.asarray(payload["v"])
    if sel is not None:
        k, v = k[:, sel], v[:, sel]
    idx = upload(np.asarray(ids, np.int64), dev)
    state.k.index_copy_(1, idx, _from_wire(k, tag, state.k.dtype, dev))
    state.v.index_copy_(1, idx, _from_wire(v, tag, state.v.dtype, dev))
    mark_written(state, ids)


def _register_carried_keys(state: PagedState, slot: int, payload: Dict):
    """Re-seed this pool's prefix cache from a payload's carried keys —
    first binding wins, so resident entries are never displaced."""
    if not state.enable_prefix_cache:
        return
    for c, hexkey in payload.get("keys", {}).items():
        key = bytes.fromhex(hexkey)
        b = int(state.block_tables[slot, int(c)])
        if b < 0 or key in state.prefix_cache or b in state.block_key:
            continue                    # existing binding wins
        state.prefix_cache[key] = b
        state.block_key[b] = key


def import_blocks(state: PagedState, slot: int, payload: Dict) -> PagedState:
    """Materialize an exported request into ``slot`` of (another) pool:
    allocate fresh OWNED (refcount-1) blocks, rebind them at the SAME
    table columns (absolute positions are preserved, so RoPE, window
    masking and the counter-based sampling replay are untouched), and
    copy the block data in on this pool's device. Carried prefix ``keys``
    are re-registered into this pool's cache (first binding wins).

    CROSS-INSTANCE DEDUPE: a column whose carried key is already resident
    in this pool's prefix cache ALIASES the resident block (incref —
    possibly reviving it off ``cached_free``) instead of materializing a
    duplicate: the content-chain key certifies the token prefix, and K/V
    is a deterministic function of it.

    Raises OutOfBlocks without mutating state when the pool or the table
    row can't hold the payload."""
    if payload["block_size"] != state.block_size:
        raise ValueError(
            f"block_size mismatch: payload {payload['block_size']} "
            f"vs pool {state.block_size}")
    if (state.block_tables[slot] >= 0).any():
        raise ValueError(f"import into non-empty slot {slot}")
    cols = np.asarray(payload["cols"], np.int64)
    n = len(cols)
    if n and int(cols.max()) >= state.block_tables.shape[1]:
        raise OutOfBlocks(
            f"import needs column {int(cols.max())}, table holds "
            f"{state.block_tables.shape[1]}")
    alias: Dict[int, int] = {}          # payload index -> resident block
    if state.enable_prefix_cache:
        for i, c in enumerate(cols):
            hexkey = payload.get("keys", {}).get(int(c))
            if hexkey is None:
                continue
            b = state.prefix_cache.get(bytes.fromhex(hexkey))
            if b is not None:
                alias[i] = b
    fresh = [i for i in range(n) if i not in alias]
    # reviving a cached-free resident consumes a unit of vacancy too —
    # account for it so the no-mutation-on-raise contract holds exactly
    revive = len({b for b in alias.values() if int(state.refcount[b]) == 0})
    if len(fresh) > state.free_block_count() - revive:
        raise OutOfBlocks(f"import needs {len(fresh)} blocks, "
                          f"{state.free_block_count() - revive} free")
    for i, b in alias.items():          # incref FIRST: aliased residents
        _incref(state, b)               # must not be evicted by the pops
        state.block_tables[slot, cols[i]] = b
    ids = [_pop_block(state) for _ in fresh]
    for b in ids:
        state.refcount[b] = 1
    if fresh:
        state.block_tables[slot, cols[fresh]] = np.asarray(ids, np.int32)
    state.lengths[slot] = payload["length"]
    state.dedup_imports += len(alias)
    state.blocks_saved_total += len(alias)
    if fresh:
        _write_blocks(state, ids, payload, np.asarray(fresh, np.int64))
    _register_carried_keys(state, slot, payload)
    return state


def import_blocks_delta(state: PagedState, slot: int,
                        payload: Dict) -> PagedState:
    """Apply a DELTA export (``export_blocks(..., since_epoch=...)``) over
    a previously imported phase-1 base in ``slot`` — the commit half of
    two-phase migration. Columns already staged are overwritten in place
    when the staged block is exclusively owned; a staged block that
    became shared (an admission aliased it) or registered is REBOUND to a
    fresh block instead — overwriting it would corrupt its co-holders /
    its cache key. New columns (decode appends past the snapshot)
    allocate fresh. ``lengths[slot]`` advances to the source's pause-time
    length. Raises OutOfBlocks without mutating state when the pool can't
    hold the new/rebound columns."""
    if payload["block_size"] != state.block_size:
        raise ValueError(
            f"block_size mismatch: payload {payload['block_size']} "
            f"vs pool {state.block_size}")
    cols = np.asarray(payload["cols"], np.int64)
    n = len(cols)
    if n and int(cols.max()) >= state.block_tables.shape[1]:
        raise OutOfBlocks(
            f"delta needs column {int(cols.max())}, table holds "
            f"{state.block_tables.shape[1]}")

    def in_place(b):
        return b >= 0 and int(state.refcount[b]) == 1 \
            and b not in state.block_key
    staged = [int(state.block_tables[slot, c]) for c in cols]
    need = sum(0 if in_place(b) else 1 for b in staged)
    if need > state.free_block_count():
        raise OutOfBlocks(f"delta needs {need} blocks, "
                          f"{state.free_block_count()} free")
    ids = []
    for c, b in zip(cols, staged):
        if in_place(b):
            ids.append(b)
            continue
        nb = _pop_block(state)
        state.refcount[nb] = 1
        if b >= 0:
            _decref(state, b)           # co-holders / cache keep the old one
        state.block_tables[slot, c] = nb
        ids.append(nb)
    state.lengths[slot] = payload["length"]
    if n:
        _write_blocks(state, ids, payload)
    _register_carried_keys(state, slot, payload)
    return state


# ------------------------------------------------------------ dense views
def gather_requests(state: PagedState, slots: Sequence[int], max_len: int):
    """Materialize G requests' KV as dense [L, G, max_len, KV, hd] in ONE
    batched pool gather. Rows past a slot's allocated columns are
    garbage — callers mask by position."""
    bs = state.block_size
    n_blk = -(-max_len // bs)
    G = len(slots)
    tbl = state.block_tables[np.asarray(slots, np.int64), :n_blk]
    tbl = to_device(np.where(tbl >= 0, tbl, 0).astype(np.int64),
                    state.k.device)                       # [G, n_blk]
    L, _, KV, _, hd = state.k.shape
    k = state.k[:, tbl]                       # [L, G, n_blk, KV, bs, hd]
    v = state.v[:, tbl]
    k = k.permute(0, 1, 2, 4, 3, 5).reshape(
        L, G, n_blk * bs, KV, hd)[:, :, :max_len]
    v = v.permute(0, 1, 2, 4, 3, 5).reshape(
        L, G, n_blk * bs, KV, hd)[:, :, :max_len]
    return k, v


def gather_request(state: PagedState, slot: int, max_len: int):
    """Single-request ``gather_requests``: dense [L, max_len, KV, hd]."""
    k, v = gather_requests(state, [slot], max_len)
    return k[:, 0], v[:, 0]


def paged_attention_ref(q, state: PagedState, slots, *, layer: int):
    """Plain paged decode attention for a batch of slots (one batched
    gather + masked softmax), as in the reference: a slot of length 0
    has no valid key and gives NaN rows.

    q: [B, H, hd]; returns [B, H, hd]."""
    B, H, hd = q.shape
    KV = state.k.shape[2]
    bs = state.block_size
    rep = H // KV
    slots = list(slots)
    lens = state.lengths[slots]                      # [B] host
    n_blk = max(1, -(-int(lens.max()) // bs))
    tbl = state.block_tables[slots, :n_blk]
    tbl = to_device(np.where(tbl >= 0, tbl, 0).astype(np.int64),
                    state.k.device)
    k = state.k[layer][tbl]                          # [B, n_blk, KV, bs, hd]
    v = state.v[layer][tbl]
    k = k.permute(0, 1, 3, 2, 4).reshape(B, n_blk * bs, KV, hd)
    v = v.permute(0, 1, 3, 2, 4).reshape(B, n_blk * bs, KV, hd)
    kh = k.repeat_interleave(rep, dim=2).float()     # [B, S, H, hd]
    vh = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), kh) / math.sqrt(hd)
    mask = (torch.arange(n_blk * bs, device=q.device)[None, :]
            < to_device(lens.astype(np.int64), q.device)[:, None])
    s = torch.where(mask[:, None, :], s, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", w, vh).to(q.dtype)
