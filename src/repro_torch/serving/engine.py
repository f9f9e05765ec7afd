"""Continuous-batching inference engine over a paged KV pool or a dense
cache (PyTorch).

Counterpart of ``repro.serving.engine``: its primary path,
``cache_kind="paged"``, iteration-level scheduling in the Orca/vLLM
style with TOKEN-BUDGET continuous batching as the default step loop;
and its dense path, ``cache_kind="dense"`` (below).

* **Scheduling** comes from the copied policy registry
  (``serving/scheduler.py``): ``budget`` packs decode tokens first, then
  in-flight prefill chunks, then fresh prompts (at most one partial,
  block-aligned chunk per step); ``slo`` splits the same budget by SLO
  class; ``phase`` keeps the legacy prefill-wave/decode-step
  alternation.
* **Prefill** runs whole prompts over a throwaway dense cache sized to
  the prompt's POWER-OF-TWO length bucket, then scatters each request's
  true-length K/V into the block pool; chunk continuations and
  prefix-cache hits run the fused ``_chunk_step`` (pool context
  gather → splice → decode-mode extend → suffix scatter). Prefix sharing
  (on by default) aliases cached full prompt blocks, refcounted and
  copy-on-write. Admission applies backpressure when the pool is out of
  blocks, and decode-time pressure preempts the youngest request.
* **Decode** is one ``forward_paged`` call per step — on the card its
  attention goes through the Hopper paged-decode kernel
  (``paged_attn_impl="kernel"``, the default) — plus batched on-device
  sampling. The only device→host transfer per step is the sampled ids
  (``instrument.fetch``); every other operand is uploaded from host
  state without a sync. Table width, prefill length and hit-group size
  are bucketed to powers of two exactly as in the reference, so shapes
  stay stable.
* **Compiled steps.** Where the reference jits its steps, the port
  captures them as CUDA graphs (serving/graphs.py), one per static key:
  the decode step (``_decode_step``: ``forward_paged`` plus sampling,
  keyed like ``_jitted_steps()``), the fused chunk prefill
  (``_chunk_step``, keyed by its pow2 bucket like ``_chunk_prefill_fn``)
  and the sampling after a prefill (``_sample_step``, keyed like
  ``_sample_fn``). A step's host operands travel as one packed upload.
  Whole-prompt prefill waves (``_run_prefill``) stay eager.
  ``cuda_graphs=False`` runs the same functions eagerly on the card; on
  the CPU they always run eagerly.

The engine is also the unit live module scaling operates on:
``pause_request`` / ``resume_request`` export and import one request's
KV blocks, position and counter-based sampling state, so the
orchestrator (serving/orchestrator.py) can migrate it mid-stream,
token-identically; the two-phase variant is ``snapshot_request`` (bulk
export, the stream keeps decoding) → destination ``prepare_resume``
(staged import into an admission-excluded slot) → ``pause_request(...,
since_epoch)`` (the dirty-set delta only) → ``commit_resume``.
``apply_plan`` puts a plan's per-layer replication degrees on the paged
decode step, quantized to the engine's replication group
(``core/replication.py``; ``group=`` a ``ReplicationGroup`` whose ranks
each run this engine with the same calls): a step under degrees above 1
splits each replicated layer's batch between the ranks and gathers it
back, every rank's pool staying a full replica and every rank sampling
the same tokens. Over a ``capturable`` group (NCCL, a card per rank)
such a step is a CUDA graph of its own key, as the reference's
``degrees`` static argument recompiles it, so a plan change recaptures
exactly this step; every rank captures and replays the same keys in
the same order, and a replay counts its gathers on the group. Over
gloo, which stages each collective through the host, it runs eagerly
(``graphs.counts.eager``). Without a group the engine is its own size-1
group, every degree quantizes to 1, and the step keeps its graph.

**The dense path** (``cache_kind="dense"``) serves the families the
pool cannot hold — SSM (Mamba2) and hybrid (Zamba2) states, MLA's
latents and the audio decoder's cross K/V — and sliding-window decoders
as a ring buffer of the window's capacity: a
``[B, max_len]`` cache (``models.transformer.init_cache``). It runs the
``phase`` scheduler whatever ``scheduler`` says, as the reference forces
it, without prefix sharing: each admission prefills one request over a
throwaway batch-1 cache of the engine's capacity (in ``prefill_chunk``
slices when that is set: the first slice as a prefill, the rest as
multi-token decode extensions), samples its first token and inserts it
into its slot (``kvcache.insert_request``, in place); an audio model's
prefill first encodes the request's frames (``encoder_input_fn(req)``,
else fp32 zeros, as the reference's engine does) and caches the cross
K/V, which every decode step then only reads; each step is one
decode+sample call over all slots (``_dense_step``), captured as a CUDA
graph keyed like the reference's ``_dense_step_impl`` jit. A prefill
from the zero state scans through the SSD kernel (``ops.ssd``; an
extension continues through ``ssd_chunked``, the op's own rule), and
``dense_attn_impl="kernel"`` sends a decode step's attention through the
decode-attention kernel where the reference's paged guards allow it (no
window, no softcap), the audio decoder's cross-attention too;
``"gather"`` is the plain computation. Module scaling
and migration target the pool: a dense engine refuses them with the
reference's ValueErrors.

The pool and the dense cache are updated in place where the reference
rebuilt them functionally.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import replication as R
from repro_torch.models import transformer as T
from repro_torch.serving import graphs as G_
from repro_torch.serving import paged_kv as PK
from repro_torch.serving import sampling as SMP
from repro_torch.serving import scheduler as SCH
from repro_torch.serving import kvcache as KV
from repro_torch.serving.instrument import fetch
from repro_torch.serving.request import MIGRATION_WIRE_VERSION, RequestSpec


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0        # 0 => greedy
    top_k: int = 0                  # 0 => full distribution
    seed: int = 0
    # SLO contract (request.RequestSpec is the construction API)
    slo_class: str = "standard"
    deadline_ms: Optional[float] = None
    # filled by the engine
    generated: list = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    preemptions: int = 0
    # chunked-prefill cursor: how many prefill tokens are already written
    # into this request's KV (always equal to pstate.lengths[slot]
    # mid-prefill)
    prefill_pos: int = 0
    prefill_start_time: Optional[float] = None   # first chunk admitted

    @property
    def done(self) -> bool:
        return self.finish_time is not None


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(eq=False)  # identity equality: Request holds arrays
class _ChunkSpec:
    """One prefill chunk ready for execution: ``n`` tokens starting at
    ``req.prefill_pos`` in ``slot``. ``fresh`` marks a first chunk whose
    admission must be rolled back if its block allocation fails."""
    req: "Request"
    slot: int
    n: int
    fresh: bool = False


# ----------------------------------------------------------------- steps
# The step functions below are what the engine's CUDA graphs hold
# (serving/graphs.py): each takes its host operands as one packed int32
# buffer (``graphs.pack`` order) and touches no host array, so a capture
# records all of it. On the CPU, and with ``cuda_graphs=False``, they run
# eagerly on the same inputs.
def _chunk_step(params, pool_k, pool_v, buf, *, cfg, window, G, n_blk, Sb,
                cache_len, dtype):
    """FUSED chunk/suffix prefill, a chunk graph's function: pool context
    gather -> throwaway dense cache splice -> decode-mode extension over
    the suffix bucket -> suffix K/V scatter back into the pool (in
    place). The operands come packed as (tbl, suffix, spos, pos,
    last_idx, bidx, oidx); ``bidx``/``oidx`` [G*Sb] are the suffix's
    scatter plan (``paged_kv.scatter_plan``), whose pad rows carry the
    scratch block, so the write has a fixed shape."""
    tbl, suffix, spos, pos, last_idx, bidx, oidx = G_.unpack(
        buf, (G, n_blk), (G, Sb), (G, Sb), (G, cache_len), (G,), (G * Sb,),
        (G * Sb,))
    L, _, KV, bs, hd = pool_k.shape
    cb = n_blk * bs
    tbl = tbl.long()
    cache = T.init_cache(cfg, G, cache_len, dtype, pool_k.device)
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    ck[:, :, :cb] = pool_k[:, tbl].permute(0, 1, 2, 4, 3, 5).reshape(
        L, G, cb, KV, hd)
    cv[:, :, :cb] = pool_v[:, tbl].permute(0, 1, 2, 4, 3, 5).reshape(
        L, G, cb, KV, hd)
    cache["positions"] = pos
    logits, cache, _ = T.forward(params, cfg, suffix, positions=spos,
                                 mode="decode", cache=cache, window=window,
                                 last_idx=last_idx.long())
    idx = spos.long()[None, :, :, None, None].expand(L, G, Sb, KV, hd)
    k_sfx = cache["layers"]["k"].gather(2, idx)      # [L, G, Sb, KV, hd]
    v_sfx = cache["layers"]["v"].gather(2, idx)
    PK.scatter_rows(pool_k, pool_v, bidx.long(), oidx.long(),
                    k_sfx.reshape(L, G * Sb, KV, hd),
                    v_sfx.reshape(L, G * Sb, KV, hd))
    return logits


def _sample_step(logits, buf, *, vocab_size, stochastic, max_top_k):
    """A sample graph's function: sample [G] tokens from [G, Vpad]
    logits, the operands packed as (temps, top-ks, seeds, counters)."""
    G = logits.shape[0]
    temps, topks, seeds, ctrs = G_.unpack(buf, (G,), (G,), (G,), (G,))
    return SMP.sample_tokens(logits, temps.view(torch.float32), topks,
                             G_.as_uint32(seeds), G_.as_uint32(ctrs),
                             vocab_size, stochastic=stochastic,
                             max_top_k=max_top_k)


def _decode_step(params, k, v, buf, *, cfg, nb, width, window, impl,
                 stochastic, max_top_k, hook=None):
    """One fused decode step, a decode graph's function: forward over the
    pool + ``_sample_step``, the operands packed as (tokens, lengths,
    active, then the sampling operands, then the block tables
    [B, width]) — the whole tables, so the graphs of every table width
    ``nb`` share one input buffer; the step reads ``tables[:, :nb]``.
    ``hook``: the replication plan's ``LayerHook`` (a replicated step:
    a graph of its own key over NCCL, eager over gloo)."""
    B = buf.numel() // (7 + width)
    tokens, lengths, active, sampling, tables = G_.unpack(
        buf, (B,), (B,), (B,), (4 * B,), (B, width))
    handle = {"k": k, "v": v, "block_tables": tables[:, :nb],
              "lengths": lengths, "active": active != 0}
    logits, _, _ = T.forward_paged(params, cfg, tokens[:, None], handle,
                                   window=window, attn_impl=impl,
                                   layer_hook=hook)
    return _sample_step(logits, sampling, vocab_size=cfg.vocab_size,
                        stochastic=stochastic, max_top_k=max_top_k)


def _dense_step(params, cache, buf, *, cfg, window, attn_impl, stochastic,
                max_top_k):
    """One dense decode step, a dense graph's function: ``forward`` in
    decode mode over the whole batch (the cache updated in place: K/V,
    positions, length and the SSM states at fixed addresses) +
    ``_sample_step``, the operands packed as (tokens, pre-step
    positions, then the sampling operands)."""
    B = buf.numel() // 6
    tokens, positions, sampling = G_.unpack(buf, (B,), (B,), (4 * B,))
    logits, _, _ = T.forward(params, cfg, tokens[:, None], positions[:, None],
                             cache, mode="decode", window=window,
                             attn_impl=attn_impl)
    return _sample_step(logits, sampling, vocab_size=cfg.vocab_size,
                        stochastic=stochastic, max_top_k=max_top_k)


def _default_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "engine on the CPU")
    return torch.device("cuda")


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_len: int = 128, dtype="float32", swa: bool = False,
                 encoder_input_fn: Optional[Callable] = None,
                 prefill_chunk: int = 0,
                 cache_kind: str = "paged", block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 paged_attn_impl: str = "kernel",
                 dense_attn_impl: str = "kernel",
                 prefix_sharing: bool = True, scheduler: str = "budget",
                 token_budget: int = 128,
                 device=None, cuda_graphs: bool = True,
                 group: Optional[R.ReplicationGroup] = None):
        if cache_kind not in ("dense", "paged"):
            raise ValueError(f"unknown cache_kind {cache_kind!r}")
        T.check_supported(cfg)
        if cache_kind == "paged" and not cfg.supports_paged_kv:
            raise ValueError(
                f"cache_kind='paged' needs a GQA attention decoder "
                f"(family={cfg.family}, attn={cfg.attention_kind})")
        for name, impl, allowed in (
                ("paged_attn_impl", paged_attn_impl, ("kernel", "gather")),
                ("dense_attn_impl", dense_attn_impl, ("kernel", "gather"))):
            if impl not in allowed:
                raise ValueError(f"unknown {name} {impl!r}")
        if device is None and group is not None:
            device = group.device
        self.device = (torch.device(device) if device is not None
                       else _default_device())
        if group is not None and not R.same_device(group.device,
                                                   self.device):
            raise ValueError(f"the replication group's device "
                             f"{group.device} is not the engine's "
                             f"{self.device}")
        # the ranks a plan's replicated layers split the batch between
        self.group = group or R.default_replication_group(self.device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_kind = cache_kind
        dense = cache_kind == "dense"
        # the dense cache ring-buffers down to a sliding window; the
        # paged path keeps the logical length (block-table columns are
        # absolute positions) and FREES leading blocks as they leave it
        self.max_len = (KV.cache_capacity(cfg, max_len, swa=swa) if dense
                        else max_len)
        self.logical_max = max_len
        self.window = cfg.sliding_window if swa else None
        self.dtype = T.torch_dtype(dtype)
        # audio: req -> the request's encoder frames [1, S_enc, d]
        self.encoder_input_fn = encoder_input_fn
        self.prefill_chunk = prefill_chunk  # 0 = one-shot prefill
        self.active: Dict[int, Request] = {}   # slot -> request
        # slots whose prompt is only PARTIALLY written (chunked prefill):
        # they hold blocks and an admission-order position but do not
        # decode yet
        self.prefilling: Dict[int, Request] = {}
        self._prefill_matched: Dict[int, list] = {}  # slot -> prefix hit
        # slots holding a STAGED phase-1 import (two-phase migration):
        # blocks resident, request still decoding at the source —
        # admission must not hand these slots out
        self._staged: Dict[int, int] = {}      # slot -> rid
        self.queue: Deque[Request] = collections.deque()
        self.clock = 0.0
        self._step_count = 0
        self.preempt_count = 0   # pool-pressure evictions
        self._admit_order: List[int] = []      # slots, oldest first
        self._admit_finished: List[Request] = []  # done at admission
        # host mirror of the dense cache's per-slot lengths (the paged
        # path's live in pstate.lengths): a decode step reads no device
        # state
        self._host_lengths = np.zeros((max_batch,), np.int64)
        self.prefix_sharing = bool(prefix_sharing) and not dense

        if dense:
            self.cache = T.init_cache(cfg, max_batch, self.max_len,
                                      self.dtype, self.device)
            self.pstate = None
            scheduler = "phase"   # chunking targets the pool's allocation
        else:
            if n_blocks is None:
                # SWA pools only need the live window (+1 block of write
                # headroom per slot); the table still spans max_len columns
                live = KV.cache_capacity(cfg, max_len, swa=swa)
                n_blocks = -(-max_batch * live // block_size)
                if self.window:
                    n_blocks += max_batch
            self.pstate = PK.init_paged(cfg, max_batch, n_blocks,
                                        block_size=block_size,
                                        dtype=self.dtype,
                                        max_len=self.max_len,
                                        prefix_cache=self.prefix_sharing,
                                        device=self.device)
            self.cache = None

        self.sched = SCH.make_scheduler(scheduler, token_budget=token_budget,
                                        chunk_align=block_size)
        self.token_budget = token_budget if self.sched.budgeted else 0
        self.last_step_packed: Optional[int] = None  # telemetry, per step

        self._paged_impl = paged_attn_impl
        self._dense_impl = dense_attn_impl
        # optional lifecycle span recorder (the observability slice fills
        # it); None keeps every hook site a falsy check
        self.span_hook = None
        self.replication_degrees: Optional[tuple] = None  # plan intent
        self._step_degrees: Optional[tuple] = None        # quantized
        # the compiled steps: one CUDA graph per static key on the card
        # (eager with cuda_graphs=False, and on the CPU); a replay counts
        # its collectives on the group, and a capture beside an NCCL
        # group's watchdog thread takes the thread-local mode
        self.graphs = G_.StepGraphs(self.device, enabled=cuda_graphs,
                                    tally=self.group.counts)
        if (self.graphs.enabled and self.group.size > 1
                and self.group.capturable):
            self.graphs.capture_error_mode = "thread_local"

    # ------------------------------------------------------------- sampling
    def _sample_batch(self, logits, reqs) -> np.ndarray:
        """Sample one token per request from [len(reqs), Vpad] logits —
        one device call + one fetch for the whole batch."""
        temps = np.asarray([r.temperature for r in reqs], np.float32)
        topks = np.asarray([r.top_k for r in reqs], np.int32)
        seeds = np.asarray([r.seed for r in reqs], np.uint32)
        ctrs = np.asarray([len(r.generated) for r in reqs], np.uint32)
        # the key of the reference's _sample_fn: shapes, stochastic,
        # max_top_k
        stochastic, max_top_k = bool((temps > 0).any()), int(topks.max())
        fn = functools.partial(_sample_step, vocab_size=self.cfg.vocab_size,
                               stochastic=stochastic, max_top_k=max_top_k)
        return fetch(self.graphs.run(
            ("sample", len(reqs), stochastic, max_top_k), fn, logits,
            G_.pack(temps, topks, seeds, ctrs)))

    def _sampling_arrays(self):
        B = self.max_batch
        temps = np.zeros((B,), np.float32)
        topks = np.zeros((B,), np.int32)
        seeds = np.zeros((B,), np.uint32)
        ctrs = np.zeros((B,), np.uint32)
        for slot, req in self.active.items():
            temps[slot] = req.temperature
            topks[slot] = req.top_k
            seeds[slot] = req.seed
            ctrs[slot] = len(req.generated)
        return temps, topks, seeds, ctrs

    # ------------------------------------------------------------- lifecycle
    def submit(self, spec: RequestSpec) -> Request:
        """Admit one request. Accepts ONLY a ``RequestSpec``; the engine
        mints and returns the mutable ``Request`` it will drive. Prompt
        ids must lie in [0, vocab_size): on the card an out-of-range id
        would trap in the embedding gather (the reference clamps it)."""
        if not isinstance(spec, RequestSpec):
            raise TypeError(
                f"Engine.submit takes a RequestSpec, got "
                f"{type(spec).__name__} (build one via "
                "repro_torch.serving.request)")
        spec.validate()
        prompt = np.asarray(spec.prompt)
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"request rid={spec.rid}: prompt ids must lie "
                             f"in [0, {self.cfg.vocab_size})")
        req = spec.to_request()
        req.submit_time = self.clock
        if self.span_hook:
            self.span_hook.on_submit(req)
        self.queue.append(req)
        return req

    def _queue_remove(self, req: Request):
        """Pop ``req`` from the waiting queue by IDENTITY."""
        for i, r in enumerate(self.queue):
            if r is req:
                del self.queue[i]
                return
        raise ValueError(f"rid={req.rid} is not in the waiting queue")

    def set_token_budget(self, budget: int) -> int:
        """Retarget the per-step token budget LIVE. No-op on phase
        engines. Returns the budget now in force."""
        if self.sched.budgeted:
            budget = max(int(budget), 1)
            self.sched.token_budget = budget
            self.token_budget = budget
        return self.token_budget

    def _free_slots(self):
        return [s for s in range(self.max_batch)
                if s not in self.active and s not in self.prefilling
                and s not in self._staged]

    def slot_rids(self) -> Dict[int, int]:
        """slot -> rid of every request holding a slot — decoding OR
        mid-prefill."""
        out = {s: r.rid for s, r in self.active.items()}
        out.update({s: r.rid for s, r in self.prefilling.items()})
        return out

    def prefill_total(self, req: Request) -> int:
        """Tokens the cache must hold before the request can decode —
        the scheduler's unit of prefill work."""
        n = len(req.prompt)
        if req.generated:
            n += len(req.generated) - 1
        return n

    @staticmethod
    def _prefill_tokens(req: Request) -> np.ndarray:
        """The prompt, plus — for a preempted request — every generated
        token except the last (which the next step feeds in)."""
        if req.generated:
            return np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(req.generated[:-1], np.int32)])
        return np.asarray(req.prompt, np.int32)

    def _run_prefill(self, tokens_2d, cache_len: Optional[int] = None,
                     enc=None, last_idx=None):
        """Batched (possibly chunked) prefill over a throwaway cache.

        The paged path sizes the cache exactly to the (bucket-padded)
        prompt — its K/V is scattered into the block pool right after;
        the dense path passes ``cache_len`` = its capacity so
        ``kvcache.insert_request`` shapes line up. With ``prefill_chunk``
        the first slice runs as a prefill and the rest as decode-mode
        extensions. ``last_idx`` [G] selects each row's last REAL token
        for the returned logits (one-shot prefill only). A dense
        engine's prefill takes its kernel routes (the SSD kernel for a
        scan from the zero state); a paged wave's prefill attends with
        ``attention`` either way. An audio model's first slice encodes
        ``enc`` [G, S_enc, d] (on the engine's device; default fp32
        zeros, the reference's). Returns (logits, cache)."""
        G, S = tokens_2d.shape
        rcache = T.init_cache(self.cfg, G, cache_len or S, self.dtype,
                              self.device)
        if self.cfg.family == "audio":
            enc = (torch.zeros((G, self.cfg.encoder_seq_len,
                                self.cfg.d_model), dtype=torch.float32,
                               device=self.device) if enc is None
                   else T.to_device(enc, self.device))
        chunk = self.prefill_chunk or S
        if last_idx is not None and chunk < S:
            raise ValueError("a per-row last-token gather needs one-shot "
                             "prefill")
        kw = dict(window=self.window)
        if self.cache_kind == "dense":
            kw.update(attn_impl=self._dense_impl, ssd_impl="kernel")
        toks = T.to_device(tokens_2d, self.device)
        first = min(chunk, S)
        logits, rcache, _ = T.forward(self.params, self.cfg, toks[:, :first],
                                      mode="prefill", cache=rcache,
                                      encoder_input=enc, last_idx=last_idx,
                                      **kw)
        off = first
        while off < S:  # chunked prefill: bound per-call work
            n = min(chunk, S - off)
            pos = torch.arange(off, off + n, dtype=torch.int32,
                               device=self.device).expand(G, n)
            logits, rcache, _ = T.forward(self.params, self.cfg,
                                          toks[:, off:off + n], pos, rcache,
                                          mode="decode", **kw)
            off += n
        return logits, rcache

    def _activate(self, req: Request, slot: int, length: int,
                  first_tok: Optional[int]):
        fresh_first = first_tok is not None and not req.generated
        req.prefill_pos = length
        if req.prefill_start_time is None:
            req.prefill_start_time = self.clock
        if first_tok is not None:
            req.generated.append(int(first_tok))
        if req.first_token_time is None:
            req.first_token_time = self.clock
        if self.span_hook:
            self.span_hook.on_activate(req, fresh_first)
        # the admission-sampled token can already satisfy a finish
        # condition: retire without ever occupying a decode slot
        hit_eos = (req.eos_id is not None and req.generated
                   and req.generated[-1] == req.eos_id)
        if hit_eos or len(req.generated) >= req.max_new_tokens:
            req.finish_time = self.clock
            req.slot = None
            if self.cache_kind == "paged":
                PK.free_slot(self.pstate, slot)
            if slot in self._admit_order:   # was mid-prefill (chunked)
                self._admit_order.remove(slot)
            if self.span_hook:
                self.span_hook.on_finish(req)
            self._admit_finished.append(req)
            return
        req.slot = slot
        self.active[slot] = req
        if slot not in self._admit_order:   # chunked slots already queued
            self._admit_order.append(slot)
        if self.cache_kind == "dense":
            self._host_lengths[slot] = length

    # ---------------------------------------------------------- dense admit
    def _admit_dense(self):
        """Admit one request per free slot: prefill it alone over a
        throwaway cache of the engine's capacity, sample its first token,
        insert its cache into the slot (in place)."""
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            toks = self._prefill_tokens(req)
            enc = (self.encoder_input_fn(req)
                   if self.cfg.family == "audio" and self.encoder_input_fn
                   else None)
            logits, rcache = self._run_prefill(toks[None, :],
                                               cache_len=self.max_len,
                                               enc=enc)
            first = None
            if not req.generated:
                first = self._sample_batch(logits, [req])[0]
            KV.insert_request(self.cache, slot, rcache, len(toks))
            self._activate(req, slot, len(toks), first)

    # ---------------------------------------------------------- paged admit
    def _admit_paged(self, wave: Optional[List[Request]] = None):
        """Admit a prefill WAVE: whole prompts, one bucketed forward per
        pow2 length group (misses) / (ctx, suffix) group (prefix hits).
        Phase scheduling pops its own wave from the queue; the
        token-budget scheduler passes the full grants it popped as
        ``wave``. Returns the requests actually admitted."""
        if wave is None:
            # phase mode still drains mid-prefill slots first: grant each
            # its full remainder
            if self.prefilling:
                self._run_chunks([
                    _ChunkSpec(req, slot,
                               self.prefill_total(req) - req.prefill_pos,
                               fresh=False)
                    for slot, req in sorted(self.prefilling.items())])
        free = self._free_slots()
        if wave is None:
            if not free or not self.queue:
                return []
            taken: List[Request] = []
            while self.queue and len(taken) < len(free):
                taken.append(self.queue.popleft())
        else:
            taken = list(wave)
            if not taken:
                return []
            if len(taken) > len(free):
                raise RuntimeError(f"wave of {len(taken)} for "
                                   f"{len(free)} free slots")
        bs = self.pstate.block_size
        ptoks = {id(r): self._prefill_tokens(r) for r in taken}

        def blocks_needed(req):
            # LIVE columns only: prompt + headroom for the first decode
            # write, minus the leading columns a sliding window retired
            S = len(ptoks[id(req)])
            cols = S // bs + 1
            if self.window:
                cols -= min(max((S - self.window + 1) // bs, 0), cols - 1)
            return cols

        def last_col(req):
            return len(ptoks[id(req)]) // bs  # the decode write head

        # pre-pass BEFORE any allocation: a request that can never fit is
        # rejected now rather than head-of-line blocking everything
        width = self.pstate.block_tables.shape[1]
        for req in taken:
            need = blocks_needed(req)
            if need > self.pstate.n_blocks or last_col(req) >= width:
                for r in reversed([t for t in taken if t is not req]):
                    self.queue.appendleft(r)
                req.finish_time = self.clock  # rejected: no output
                raise PK.OutOfBlocks(
                    f"request rid={req.rid} needs {need} live blocks up "
                    f"to column {last_col(req)}; pool has "
                    f"{self.pstate.n_blocks}, table rows hold {width}")

        admitted: List[Request] = []
        slot_of: Dict[int, int] = {}
        ctx_of: Dict[int, int] = {}       # id(req) -> aliased context tokens
        matched_of: Dict[int, list] = {}  # id(req) -> matched block ids
        for idx, req in enumerate(taken):
            slot = free[len(admitted)]
            toks = ptoks[id(req)]
            # prefix-cache lookup BEFORE the backpressure check: a hit
            # only needs pool capacity for its suffix. The adopted
            # context is capped at S-1 so at least one suffix token
            # remains to produce first-token logits
            matched = (PK.match_prefix(self.pstate, toks, record=False)
                       if self.prefix_sharing and not self.window else [])
            ctx = min(len(matched) * bs, len(toks) - 1)
            if not (matched and ctx >= 1):
                matched, ctx = [], 0
            revive = sum(1 for b in matched
                         if int(self.pstate.refcount[b]) == 0)
            if (blocks_needed(req) - len(matched)
                    > self.pstate.free_block_count() - revive):
                # out of blocks: backpressure — requeue IN ORDER and stop
                for r in reversed(taken[idx:]):
                    self.queue.appendleft(r)
                break
            if matched:
                try:
                    PK.adopt_prefix(self.pstate, slot, matched, ctx)
                    PK.allocate(self.pstate, slot, len(toks) - ctx)
                except PK.OutOfBlocks:
                    PK.free_slot(self.pstate, slot)   # decref the adoption
                    for r in reversed(taken[idx:]):
                        self.queue.appendleft(r)
                    break
                ctx_of[id(req)] = ctx
            else:
                PK.allocate(self.pstate, slot, len(toks),
                            window=self.window)
                if self.prefix_sharing and not self.window:
                    # publish this prompt's full blocks NOW so wave-mates
                    # behind it match them (their reads run only after
                    # this wave's prefill writes)
                    PK.register_prefix(self.pstate, slot, toks)
            matched_of[id(req)] = matched
            slot_of[id(req)] = slot
            admitted.append(req)
        # group prompts into power-of-two LENGTH BUCKETS (pad + per-row
        # last-token gather); activate in SUBMISSION order
        groups: Dict[int, List[Request]] = {}
        for req in admitted:
            if id(req) in ctx_of:
                continue        # prefix-cache hit: suffix-only path below
            S = len(ptoks[id(req)])
            # chunked prefill keeps exact lengths (chunking bounds shapes)
            Sb = S if self.prefill_chunk else _pow2_at_least(S)
            groups.setdefault(Sb, []).append(req)
        first_of: Dict[int, Optional[int]] = {}
        for Sb, reqs in groups.items():
            lens = [len(ptoks[id(r)]) for r in reqs]
            toks = np.zeros((len(reqs), Sb), np.int32)
            for i, r in enumerate(reqs):
                toks[i, :lens[i]] = ptoks[id(r)]
            last = (None if self.prefill_chunk else
                    T.to_device(np.asarray(lens, np.int64) - 1, self.device))
            logits, rcache = self._run_prefill(toks, last_idx=last)
            firsts = self._sample_batch(logits, reqs)
            PK.write_tokens_batch(
                self.pstate, [slot_of[id(r)] for r in reqs],
                rcache["layers"]["k"], rcache["layers"]["v"], lengths=lens)
            for i, req in enumerate(reqs):
                first_of[id(req)] = None if req.generated else firsts[i]
        # cache hits: prefill the suffix only — grouped by (pow2 context
        # bucket, pow2 suffix bucket), one batched extend per group
        hit_groups: Dict[tuple, List[Request]] = {}
        for req in admitted:
            if id(req) not in ctx_of:
                continue
            ctx = ctx_of[id(req)]
            n_new = len(ptoks[id(req)]) - ctx
            key = (_pow2_at_least(max(ctx, 1)), _pow2_at_least(n_new))
            hit_groups.setdefault(key, []).append(req)
        failed: List[Request] = []
        for (cb, Sb), greqs in hit_groups.items():
            ok: List[Request] = []
            for req in greqs:
                # copy-on-write forks BEFORE the group forward; a fork
                # that finds no free block drops just that request
                try:
                    PK.ensure_writable(self.pstate, slot_of[id(req)],
                                       ctx_of[id(req)],
                                       len(ptoks[id(req)]) - ctx_of[id(req)])
                    ok.append(req)
                except PK.OutOfBlocks:
                    PK.free_slot(self.pstate, slot_of[id(req)])
                    failed.append(req)
            if not ok:
                continue
            # pad the GROUP dim to a power of two as well (dummy rows
            # replicate the last member; their pool writes are filtered
            # out, their logits discarded)
            Gb = _pow2_at_least(len(ok))
            pad = [ok[-1]] * (Gb - len(ok))
            logits = self._prefill_shared_batch(
                [slot_of[id(r)] for r in ok + pad],
                [ptoks[id(r)] for r in ok + pad],
                [ctx_of[id(r)] for r in ok + pad], cb, Sb,
                n_real=len(ok))
            if self.prefix_sharing and not self.window:
                for r in ok:
                    PK.register_prefix(self.pstate, slot_of[id(r)],
                                       ptoks[id(r)])
            firsts = self._sample_batch(logits, ok + pad)[:len(ok)]
            for i, r in enumerate(ok):
                first_of[id(r)] = None if r.generated else firsts[i]
        if failed:
            for r in reversed(failed):      # preserve submission order
                self.queue.appendleft(r)
            failed_ids = {id(r) for r in failed}
            admitted = [r for r in admitted if id(r) not in failed_ids]
        for req in admitted:
            if self.prefix_sharing and not self.window:
                # gauge bookkeeping once per SUCCESSFUL admission
                PK.record_lookup(self.pstate, ptoks[id(req)],
                                 matched_of[id(req)])
            self._activate(req, slot_of[id(req)], len(ptoks[id(req)]),
                           first_of[id(req)])
        if self.window:
            for req in admitted:
                if req.slot is not None:  # may have retired at admission
                    PK.free_out_of_window(self.pstate, req.slot, self.window)
        return admitted

    def _prefill_shared_batch(self, slots: List[int], toks_list,
                              ctxs: List[int], cb: int, Sb: int,
                              n_real: Optional[int] = None):
        """Bucketed suffix-only prefill for a GROUP of chunk continuations
        or prefix-cache hits: splice every member's written context (ONE
        batched pool gather) into a throwaway dense cache, run one
        decode-mode continuation over the padded suffix rows, and scatter
        ONLY the suffix K/V back. Per-row true context lengths ride in the
        positions array (BIG_POS past ctx_i masks those rows out). Callers
        run ``ensure_writable`` (CoW fork) per member beforehand."""
        G = len(slots)
        n_real = G if n_real is None else n_real
        # dummy pad rows (duplicated slots past n_real) scatter nothing:
        # their new-token count is 0, so the scatter plan drops them
        n_news = [(len(t) - c) if i < n_real else 0
                  for i, (t, c) in enumerate(zip(toks_list, ctxs))]
        cache_len = cb + Sb
        st = self.pstate
        bs = st.block_size
        n_blk = -(-cb // bs)
        tbl = st.block_tables[np.asarray(slots, np.int64), :n_blk]
        tbl = np.where(tbl >= 0, tbl, 0)   # holes gather garbage; masked
        pos = np.full((G, cache_len), T.BIG_POS, np.int32)
        suffix = np.zeros((G, Sb), np.int32)
        spos = np.zeros((G, Sb), np.int32)
        for i, (toks, ctx, n_new) in enumerate(zip(toks_list, ctxs,
                                                   n_news)):
            pos[i, :ctx] = np.arange(ctx)
            suffix[i, :n_new] = toks[ctx:ctx + n_new]
            spos[i] = np.arange(ctx, ctx + Sb)
        # host half of the pool append (advances lengths, stamps epoch);
        # pad rows carry the scratch block
        bidx, oidx = PK.scatter_plan(st, slots, Sb, lengths=n_news)
        # the key of the reference's _chunk_prefill_fn: the pow2 (group,
        # context, suffix) bucket and the dense cache's length
        fn = functools.partial(_chunk_step, self.params, st.k, st.v,
                               cfg=self.cfg, window=self.window, G=G,
                               n_blk=n_blk, Sb=Sb, cache_len=cache_len,
                               dtype=self.dtype)
        return self.graphs.run(
            ("chunk", G, cb, Sb, cache_len), fn,
            G_.pack(tbl, suffix, spos, pos, np.asarray(n_news) - 1, bidx,
                    oidx))

    def _admit(self):
        if self.cache_kind == "dense":
            self._admit_dense()
        elif self.sched.budgeted:
            self._admit_budget()
        else:
            self._admit_paged()

    # ------------------------------------- token-budget admission (CB)
    def _admit_budget(self):
        """One continuous-batching admission pass: ask the scheduler how
        this step's token budget packs, then execute the grants — whole
        prompts ride the bucketed wave machinery, chunk grants run
        through ``_run_chunks``."""
        plan = self.sched.plan(self)
        self.last_step_packed = plan.packed
        cont = [g for g in plan.grants if g.slot is not None]
        chunks = [_ChunkSpec(g.req, g.slot, g.n_tokens) for g in cont]
        wave: List[Request] = []
        partial = None
        for g in plan.grants:
            if g.slot is not None:
                continue
            if g.final:
                # granted fresh requests need not be a queue PREFIX —
                # class-aware policies admit out of FIFO order
                self._queue_remove(g.req)
                wave.append(g.req)
            else:
                partial = g         # stays queued for now
        requeued = False
        if wave:
            admitted = self._admit_paged(wave)
            requeued = len(admitted) < len(wave)
        if partial is not None and not requeued:
            # pool pressure on the wave means the partial (younger) grant
            # would only add pressure — leave it queued, FIFO intact
            spec = self._begin_chunked(partial.req, partial.n_tokens)
            if spec is not None:
                chunks.append(spec)
        ran = self._run_chunks(chunks) if chunks else 0
        # forward-progress guard: nothing decoding, nothing admitted,
        # every chunk blocked on the pool -> preempt the youngest
        # prefilling slot so the oldest can finish
        if (not self.active and not ran and not wave
                and len(self.prefilling) > 1):
            victims = [s for s in self._admit_order
                       if s in self.prefilling]
            if len(victims) > 1:
                self._preempt(victims[-1])

    def _begin_chunked(self, req: Request, n: int) -> Optional[_ChunkSpec]:
        """Admit a WAITING request with a partial grant: claim a slot, run
        the never-fits rejection and prefix-cache lookup, and hand back
        the first chunk. Returns None when nothing was admitted."""
        if not any(r is req for r in self.queue):
            raise RuntimeError(f"rid={req.rid} is not queued")
        toks = self._prefill_tokens(req)
        S = len(toks)
        bs = self.pstate.block_size
        width = self.pstate.block_tables.shape[1]
        need = S // bs + 1
        if self.window:
            need -= min(max((S - self.window + 1) // bs, 0), need - 1)
        if need > self.pstate.n_blocks or S // bs >= width:
            self._queue_remove(req)
            req.finish_time = self.clock  # rejected: no output
            if self.span_hook:
                self.span_hook.on_finish(req)
            raise PK.OutOfBlocks(
                f"request rid={req.rid} needs {need} live blocks up to "
                f"column {S // bs}; pool has {self.pstate.n_blocks}, "
                f"table rows hold {width}")
        free = self._free_slots()
        if not free:
            return None
        slot = free[0]
        matched = (PK.match_prefix(self.pstate, toks, record=False)
                   if self.prefix_sharing and not self.window else [])
        ctx = min(len(matched) * bs, S - 1)
        if not (matched and ctx >= 1):
            matched, ctx = [], 0
        if matched:
            PK.adopt_prefix(self.pstate, slot, matched, ctx)
        self._queue_remove(req)
        req.slot = slot
        req.prefill_pos = ctx
        if req.prefill_start_time is None:
            req.prefill_start_time = self.clock
        self.prefilling[slot] = req
        self._admit_order.append(slot)
        self._prefill_matched[slot] = matched
        return _ChunkSpec(req, slot, min(n, S - ctx), fresh=True)

    def _run_chunks(self, specs: List[_ChunkSpec]) -> int:
        """Execute prefill chunks: allocate each chunk's block columns,
        then run them as ONE bucketed suffix prefill (pow2 context, pow2
        chunk, group padded to pow2). Final chunks sample the first token
        and move the request into decode rotation. Returns the number of
        chunks that ran."""
        st = self.pstate
        bs = st.block_size
        ready: List[_ChunkSpec] = []
        for sp in specs:
            if self.prefilling.get(sp.slot) is not sp.req:
                continue   # preempted by the decode-room pass: replays
            start = sp.req.prefill_pos
            if int(st.lengths[sp.slot]) != start:
                raise RuntimeError(f"slot {sp.slot}: pool holds "
                                   f"{int(st.lengths[sp.slot])} tokens, "
                                   f"cursor at {start}")
            try:
                PK.allocate(st, sp.slot, sp.n, window=self.window)
                if self.prefix_sharing:
                    # the chunk may write into an adopted (shared) tail
                    # block: fork it first, copy-on-write
                    PK.ensure_writable(st, sp.slot, start, sp.n)
            except PK.OutOfBlocks:
                if sp.fresh:
                    # first chunk found no blocks: undo the admission so
                    # the request waits in the QUEUE, not in a slot
                    del self.prefilling[sp.slot]
                    self._admit_order.remove(sp.slot)
                    self._prefill_matched.pop(sp.slot, None)
                    PK.free_slot(st, sp.slot)
                    sp.req.slot = None
                    sp.req.prefill_pos = 0
                    self.queue.appendleft(sp.req)
                continue                    # continuation retries next step
            ready.append(sp)
        if not ready:
            return 0
        # ONE group per step: per-row true starts ride in the positions
        # array, so mixing context lengths costs gather width only
        width_tokens = st.block_tables.shape[1] * bs
        starts = [int(st.lengths[sp.slot]) for sp in ready]
        cb = min(_pow2_at_least(max(max(starts), 1)), width_tokens)
        Sb = _pow2_at_least(max(sp.n for sp in ready))
        gsp = ready
        Gb = _pow2_at_least(len(gsp))
        padded = gsp + [gsp[-1]] * (Gb - len(gsp))
        toks_list = [self._prefill_tokens(sp.req)[:sp.req.prefill_pos
                                                  + sp.n]
                     for sp in padded]
        ctxs = [sp.req.prefill_pos for sp in padded]
        t_chunk0 = self.span_hook.now() if self.span_hook else 0.0
        logits = self._prefill_shared_batch(
            [sp.slot for sp in padded], toks_list, ctxs, cb, Sb,
            n_real=len(gsp))
        if self.span_hook:
            t_chunk1 = self.span_hook.now()
            for sp in gsp:
                self.span_hook.on_chunk(sp.req.rid, sp.req.prefill_pos,
                                        sp.n, t_chunk0, t_chunk1)
        finals = [sp for sp in gsp
                  if sp.req.prefill_pos + sp.n
                  >= self.prefill_total(sp.req)]
        toks = None
        if any(not sp.req.generated for sp in finals):
            # one sampling sync per step, and ONLY when some member
            # finished its prompt
            toks = self._sample_batch(
                logits, [sp.req for sp in padded])[:len(gsp)]
        for i, sp in enumerate(gsp):
            sp.req.prefill_pos += sp.n   # mirrors pstate.lengths
            if sp in finals:
                first = (None if sp.req.generated else int(toks[i]))
                self._finish_prefill(sp.req, sp.slot, first)
        if self.window:
            for sp in gsp:
                if sp.slot in self.prefilling \
                        or sp.slot in self.active:
                    PK.free_out_of_window(st, sp.slot, self.window)
        return len(ready)

    def _finish_prefill(self, req: Request, slot: int,
                        first: Optional[int]):
        """Last chunk landed: publish the finished prompt to the prefix
        cache, count the lookup once, and move the request into decode
        rotation."""
        del self.prefilling[slot]
        matched = self._prefill_matched.pop(slot, [])
        if self.prefix_sharing and not self.window:
            toks = self._prefill_tokens(req)
            PK.register_prefix(self.pstate, slot, toks)
            PK.record_lookup(self.pstate, toks, matched)
        self._activate(req, slot, req.prefill_pos, first)

    # ------------------------------------------------------------ preemption
    def _preempt(self, slot: int):
        """Return the request in ``slot`` to the queue head and free its
        blocks. Counter-based sampling keys make the resumed continuation
        identical to the uninterrupted one."""
        if slot in self.active:
            req = self.active.pop(slot)
        else:
            req = self.prefilling.pop(slot)
            self._prefill_matched.pop(slot, None)
        self._admit_order.remove(slot)
        PK.free_slot(self.pstate, slot)
        req.slot = None
        req.prefill_pos = 0
        req.preemptions += 1
        self.preempt_count += 1
        if self.span_hook:
            self.span_hook.on_preempt(req.rid)
        self.queue.appendleft(req)

    def _ensure_decode_room(self):
        """Every active slot needs pool room for one more token; under
        pressure, preempt the scheduler's preferred victim. A lone
        request that has outgrown the pool is evicted with its partial
        output before raising."""
        for slot in sorted(self.active.keys()):
            while slot in self.active:
                try:
                    PK.allocate(self.pstate, slot, 1)
                    if self.prefix_sharing:
                        # copy-on-write: the step writes this slot's next
                        # token into column lengths//bs — fork it if shared
                        PK.ensure_writable(self.pstate, slot,
                                           int(self.pstate.lengths[slot]), 1)
                    break
                except PK.OutOfBlocks:
                    victims = self.sched.victims(self)
                    if len(victims) <= 1:
                        req = self.active[slot]
                        req.finish_time = self.clock  # truncated output
                        if self.span_hook:
                            self.span_hook.on_finish(req)
                        self._retire(slot)
                        raise PK.OutOfBlocks(
                            f"request rid={req.rid} outgrew the pool at "
                            f"{len(req.generated)} generated tokens; "
                            f"evicted with truncated output")
                    self._preempt(victims[-1])

    # ------------------------------------------------------------------ step
    def step(self, dt: float = 1.0):
        """One engine iteration: admit from queue, one decode+sample call
        for all active slots, retire finished requests. Exactly one
        device→host sync (the sampled-token fetch) in steady state, and
        one more per collective of a replicated step staged through the
        host (gloo on the card; NCCL's run on the card)."""
        self.clock += dt
        self.last_step_packed = None   # set by the token-budget planner
        self._admit()
        finished = self._admit_finished
        self._admit_finished = []
        if self.cache_kind == "paged" and self.active:
            # may preempt: must run BEFORE the step snapshots active slots
            self._ensure_decode_room()
        if not self.active:
            return finished or None
        B = self.max_batch
        tokens = np.zeros((B,), np.int32)
        active_mask = np.zeros((B,), bool)
        for slot, req in self.active.items():
            tokens[slot] = req.generated[-1]
            active_mask[slot] = True
        temps, topks, seeds, ctrs = self._sampling_arrays()
        stochastic, max_top_k = bool((temps > 0).any()), int(topks.max())
        if self.cache_kind == "dense":
            pre_lengths = self._host_lengths.copy()
            # the key of the reference's _dense_step_impl jit (cfg is the
            # engine's): sampling's static arguments and the window; the
            # attention route
            key = ("dense", stochastic, max_top_k, self.window,
                   self._dense_impl)
            fn = functools.partial(_dense_step, self.params, self.cache,
                                   cfg=self.cfg, window=self.window,
                                   attn_impl=self._dense_impl,
                                   stochastic=stochastic,
                                   max_top_k=max_top_k)
            toks = fetch(self.graphs.run(key, fn, G_.pack(
                tokens, pre_lengths, temps, topks, seeds, ctrs)))
            self._host_lengths[active_mask] += 1
            self._step_count += 1
            return self._finish_step(toks, pre_lengths, finished)

        st = self.pstate
        pre_lengths = st.lengths.copy()
        bs = st.block_size
        # power-of-2 bucket of the widest needed table prefix, derived
        # from LENGTHS (window-freed rows have leading holes)
        need = int(st.lengths[active_mask].max()) // bs + 1
        nb = min(_pow2_at_least(max(need, 1)), st.block_tables.shape[1])
        # the key of the reference's _jitted_steps() paged step (cfg is
        # the engine's): table width, sampling's static arguments,
        # replication degrees (all ones run the plain step), attention
        # impl, window. Lengths, tokens and sampling values never re-key.
        degrees = self._step_degrees
        if degrees is not None and all(d == 1 for d in degrees):
            degrees = None
        key = ("decode", nb, stochastic, max_top_k, degrees,
               self._paged_impl, self.window)
        fn = functools.partial(_decode_step, self.params, st.k, st.v,
                               cfg=self.cfg, nb=nb,
                               width=st.block_tables.shape[1],
                               window=self.window, impl=self._paged_impl,
                               stochastic=stochastic, max_top_k=max_top_k)
        operands = G_.pack(tokens, st.lengths, active_mask, temps, topks,
                           seeds, ctrs, st.block_tables)
        if degrees is None:
            toks_dev = self.graphs.run(key, fn, operands)
        else:
            # a replicated step: a graph where the group's collectives run
            # on the card (NCCL), else eager (gloo stages them through the
            # host)
            fn = functools.partial(
                fn, hook=R.layer_hook_from_degrees(degrees, self.group))
            run = (self.graphs.run if self.group.capturable
                   else self.graphs.eager)
            toks_dev = run(key, fn, operands)
        toks = fetch(toks_dev)     # the ONE host sync
        st.lengths[active_mask] += 1
        # dirty-set bookkeeping: the step wrote each active slot's token
        # into the block at its pre-step write head
        PK.mark_written(st, [
            int(st.block_tables[s, int(pre_lengths[s]) // bs])
            for s in self.active])
        if self.window:
            for slot in self.active:
                PK.free_out_of_window(st, slot, self.window)
        self._step_count += 1
        return self._finish_step(toks, pre_lengths, finished)

    def _finish_step(self, toks, pre_lengths, finished):
        """Append each active slot's sampled token; retire the requests
        that hit eos, their token budget or the logical length."""
        for slot, req in list(self.active.items()):
            tok = int(toks[slot])
            req.generated.append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            full = len(req.generated) >= req.max_new_tokens
            over = int(pre_lengths[slot]) + 2 >= self.logical_max
            if hit_eos or full or over:
                req.finish_time = self.clock
                if self.span_hook:
                    self.span_hook.on_finish(req)
                finished.append(req)
                self._retire(slot)
        return finished

    def _retire(self, slot: int):
        del self.active[slot]
        self._admit_order.remove(slot)
        if self.cache_kind == "paged":
            PK.free_slot(self.pstate, slot)
        else:
            self._host_lengths[slot] = 0
            KV.evict_request(self.cache, slot)

    def prefix_stats(self) -> dict:
        """Live prefix-sharing gauges (hit rate, CoW forks, blocks saved);
        zeros for a dense engine."""
        if self.cache_kind != "paged":
            return {"queries": 0, "hits": 0, "hit_rate": 0.0,
                    "cow_forks": 0, "blocks_saved_total": 0,
                    "blocks_saved_now": 0, "cached_blocks": 0}
        return PK.prefix_stats(self.pstate)

    @property
    def block_size(self) -> int:
        """Pool block granularity (0 for a dense engine) — what the pod
        router hashes incoming prompts by (serving/router.py)."""
        return self.pstate.block_size if self.cache_kind == "paged" else 0

    def prefix_keys(self) -> set:
        """Hex-encoded content-chain keys RESIDENT in this engine's
        prefix cache — the router's affinity signal (empty for a dense
        engine)."""
        if self.cache_kind != "paged" or not self.prefix_sharing:
            return set()
        return {k.hex() for k in self.pstate.prefix_cache}

    def stream_progress(self) -> Dict[int, List[int]]:
        """rid -> tokens generated so far, for every SLOT-HOLDING
        request (decoding or mid-prefill). Full lists, not deltas."""
        out = {r.rid: list(r.generated) for r in self.active.values()}
        out.update({r.rid: list(r.generated)
                    for r in self.prefilling.values()})
        return out

    def run_until_done(self, max_steps: int = 10_000):
        out = []
        steps = 0
        while (self.queue or self.active or self.prefilling) \
                and steps < max_steps:
            fin = self.step() or []
            out.extend(fin)
            steps += 1
        return out

    # ------------------------------------------- live module scaling API
    def apply_plan(self, plan):
        """Apply a PlacementPlan's per-layer replication degrees (P) to
        the live decode step from the next step on, no drain. Degrees are
        quantized to the engine's replication group: without a group
        every degree becomes 1 and the step — and so every token stream
        — is unchanged; in a group every rank applies the same plan at
        the same step (``forward_paged``'s ``layer_hook``)."""
        if self.cache_kind != "paged":
            raise ValueError("apply_plan targets the paged decode step; "
                             "dense engines predate module scaling")
        p = tuple(plan.p) if hasattr(plan, "p") else tuple(plan)
        if len(p) != self.cfg.num_layers:
            raise ValueError(f"plan covers {len(p)} layers, "
                             f"model has {self.cfg.num_layers}")
        if all(d == 1 for d in p):
            self.replication_degrees, self._step_degrees = p, None
            return
        q = tuple(R.quantize_degrees(list(p), self.group.size))
        self.replication_degrees, self._step_degrees = p, q

    # --------------------------------------- request migration (paged)
    def pause_request(self, slot: int, since_epoch: Optional[int] = None,
                      wire: str = "bits") -> dict:
        """Detach the request in ``slot`` (decoding, or mid-prefill) and
        export its serving state: KV blocks (paged_kv.export_blocks wire
        format), position, and the counter-based sampling state, which
        the Request itself carries (seed, len(generated)). Shared blocks
        are materialized into the payload with their prefix keys; the
        slot then releases its claim. The payload is a finished host copy
        before the blocks are freed. ``resume_request`` on any engine
        with identical cfg/params continues the stream token-identically.

        ``since_epoch`` (a prior ``snapshot_request``'s ``epoch``) makes
        this the phase-2 pause of an overlapped migration: the payload
        carries only the blocks written since the snapshot. ``wire`` is
        ``paged_kv.export_blocks``' choice: ``"bits"`` for a port peer,
        ``"float32"`` for a peer that reads arrays by value (the JAX
        package)."""
        if self.cache_kind != "paged":
            raise ValueError("pause/resume migrates paged KV blocks; "
                             "dense slabs go through core.migration")
        if slot in self.active:
            req = self.active.pop(slot)
            phase = "decode"
        else:
            # a MID-PREFILL request pauses too: the cursor (lengths ==
            # prefill_pos) and the chunk-written blocks travel
            req = self.prefilling.pop(slot)
            self._prefill_matched.pop(slot, None)
            phase = "prefill"
        self._admit_order.remove(slot)
        if self.span_hook:
            self.span_hook.on_pause(req.rid)
        payload = PK.export_blocks(self.pstate, slot,
                                   since_epoch=since_epoch, wire=wire)
        PK.free_slot(self.pstate, slot)
        req.slot = None
        # "position"/"counter" are informational mirrors: import_blocks
        # restores the position from kv["length"], the sampler re-derives
        # the counter from len(request.generated)
        return {"v": MIGRATION_WIRE_VERSION, "request": req, "kv": payload,
                "position": payload["length"],
                "counter": len(req.generated),
                "phase": phase}

    @staticmethod
    def _check_payload_version(payload: dict, op: str):
        """Reject an old- or alien-shape migration payload with a clear
        error rather than a KeyError deep inside the bind path."""
        v = payload.get("v") if isinstance(payload, dict) else None
        if v != MIGRATION_WIRE_VERSION:
            raise ValueError(
                f"{op}: migration payload version {v!r} unsupported "
                f"(this engine speaks v{MIGRATION_WIRE_VERSION}; "
                "re-export from a matching peer)")

    def resume_request(self, payload: dict) -> bool:
        """Rebind a paused request's blocks into this engine's pool and
        put it back in rotation. Returns False — WITHOUT dropping the
        request or touching the pool — when no slot or not enough blocks
        are free (the caller re-queues it; counter-based sampling replays
        the continuation deterministically)."""
        if self.cache_kind != "paged":
            raise ValueError("resume_request needs a paged engine")
        self._check_payload_version(payload, "resume_request")
        req = payload["request"]
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        try:
            PK.import_blocks(self.pstate, slot, payload["kv"])
        except PK.OutOfBlocks:
            return False
        self._bind_resumed(req, slot, payload)
        return True

    def _bind_resumed(self, req: Request, slot: int, payload: dict):
        """Place a migrated-in request: decode rotation, or — paused
        MID-PREFILL — the prefilling set with its cursor restored from
        the imported length."""
        req.slot = slot
        if payload.get("phase", "decode") == "prefill":
            req.prefill_pos = int(payload["kv"]["length"])
            self.prefilling[slot] = req
        else:
            self.active[slot] = req
        self._admit_order.append(slot)  # migrated-in = youngest
        if self.span_hook:
            self.span_hook.on_resume(req, payload.get("phase", "decode"))

    # ------------------------------- overlapped (two-phase) migration
    def snapshot_request(self, slot: int, wire: str = "bits") -> dict:
        """Phase 1 of an overlapped migration: export the request in
        ``slot`` WITHOUT detaching it — the payload is a host copy, so the
        stream keeps decoding into its tail block meanwhile. The returned
        ``epoch`` is the dirty-set cursor for the phase-2
        ``pause_request(slot, since_epoch=epoch)``; ``wire`` as there."""
        if self.cache_kind != "paged":
            raise ValueError("snapshot_request needs a paged engine")
        req = (self.active.get(slot) or self.prefilling[slot])
        payload = PK.export_blocks(self.pstate, slot, wire=wire)
        return {"v": MIGRATION_WIRE_VERSION, "rid": req.rid, "kv": payload,
                "epoch": payload["epoch"], "position": payload["length"]}

    def prepare_resume(self, snap: dict) -> Optional[int]:
        """Stage a phase-1 snapshot into a free slot that admission
        cannot touch (``_staged``), activating nothing. Returns the
        staging slot, or None (without mutating the pool) when no slot or
        not enough blocks are free."""
        if self.cache_kind != "paged":
            raise ValueError("prepare_resume needs a paged engine")
        self._check_payload_version(snap, "prepare_resume")
        free = self._free_slots()
        if not free:
            return None
        slot = free[0]
        try:
            PK.import_blocks(self.pstate, slot, snap["kv"])
        except PK.OutOfBlocks:
            return None
        self._staged[slot] = snap["rid"]
        return slot

    def commit_resume(self, slot: int, payload: dict) -> bool:
        """Phase 2: apply the pause-time delta over the staged base and
        put the request into rotation. On OutOfBlocks the staging is
        rolled back and False returned — the caller re-queues the
        request, which replays deterministically."""
        assert slot in self._staged, f"slot {slot} holds no staged import"
        self._check_payload_version(payload, "commit_resume")
        req = payload["request"]
        try:
            PK.import_blocks_delta(self.pstate, slot, payload["kv"])
        except PK.OutOfBlocks:
            self.abort_resume(slot)
            return False
        del self._staged[slot]
        # the phase is decided at PAUSE time: a request snapshotted
        # mid-prefill may have finished its prompt during the overlap
        self._bind_resumed(req, slot, payload)
        return True

    def abort_resume(self, slot: int):
        """Drop a staged phase-1 import: free the staged blocks and
        return the slot to admission."""
        if slot in self._staged:
            del self._staged[slot]
            PK.free_slot(self.pstate, slot)
