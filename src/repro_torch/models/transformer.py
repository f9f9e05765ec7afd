"""Decoder stack of the dense and MoE GQA families, prefill/decode over a
dense cache and single-token decode over a paged block pool.

PyTorch counterpart of ``repro.models.transformer`` for the families this
port covers so far (``dense``, ``moe`` and ``vlm`` decoders with GQA
attention; an MoE layer takes the MLP's place, ``models/moe.py``).
Parameters are a nested dict with the reference's keys and the stacked
``[L, ...]`` layer layout, so ``bridge.params_from_numpy`` maps the JAX
tree key for key; the stack runs as a Python loop over layers.

Cache tensors (the dense cache's K/V and positions, the paged pool) are
updated IN PLACE, where the reference rebuilt them functionally.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

BIG_POS = 2 ** 30


def torch_dtype(dtype) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` / a torch dtype -> torch dtype."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def to_device(a, device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) on ``device`` without a host
    sync: on CUDA the copy goes through pinned memory, non-blocking (a
    pageable copy would wait for the card). A numpy input is copied, so
    later host edits never reach the result."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    device = torch.device(device)
    if device.type == "cuda" and a.device.type == "cpu":
        return a.pin_memory().to(device, non_blocking=True)
    return a.to(device)


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError, naming the ROADMAP item, for what this
    slice of the port does not cover yet."""
    if cfg.family not in ("dense", "moe", "vlm") or cfg.attention_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family} attention={cfg.attention_kind} "
            f"is not ported yet (ROADMAP A9: dense cache and other families)")


# ======================================================================= init
def init_params(cfg: ModelConfig, gen: torch.Generator, dtype="bfloat16"):
    """Random weights from ``gen`` (on ``gen.device``), with the reference
    tree's keys and shapes; the same distributions as the reference
    (scaled normal embedding, truncated-normal fan-in dense layers). An
    MoE config gets ``layers["moe"]`` in place of ``layers["mlp"]``, as
    the reference's ``_init_decoder_layer`` builds it."""
    check_supported(cfg)
    dtype = torch_dtype(dtype)
    dev = gen.device
    lead = (cfg.num_layers,)
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                        device=dev, dtype=torch.float32)
    params = {
        "embed": (embed * (1.0 / math.sqrt(cfg.d_model))).to(dtype),
        "final_norm": L.init_norm(cfg, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         dtype)
    params["layers"] = {
        "norm1": L.init_norm(cfg, dtype, dev, lead=lead),
        "attn": L.init_gqa(cfg, gen, dtype, lead=lead),
        "norm2": L.init_norm(cfg, dtype, dev, lead=lead),
    }
    if cfg.num_experts > 0:
        params["layers"]["moe"] = MOE.init_moe(cfg, gen, dtype, lead=lead)
    else:
        params["layers"]["mlp"] = L.init_mlp(cfg, gen, dtype, lead=lead)
    return params


# ====================================================================== cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype="bfloat16",
               device="cuda"):
    """Dense serving cache: K/V ``[L, B, max_len, KV, hd]``, per-row
    absolute positions (unwritten rows hold BIG_POS so they mask out)."""
    check_supported(cfg)
    dtype = torch_dtype(dtype)
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, hd)
    return {
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
        "positions": torch.full((batch, max_len), BIG_POS,
                                dtype=torch.int32, device=device),
        "layers": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)},
    }


# ================================================================= embeddings
def embed_tokens(params, cfg: ModelConfig, tokens):
    """Token ids must lie below the vocab size: ``jnp.take`` clamps an
    out-of-range id, torch indexing on the card traps. The engine checks
    prompts at submission, and sampled ids are below the vocab size."""
    x = params["embed"][tokens]
    if cfg.scale_embed:
        # the factor rounds to x's type first, as in the reference;
        # torch.full fills on the device (no host->device copy)
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


def unembed(params, cfg: ModelConfig, x):
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        logits = torch.einsum("...d,vd->...v", x, params["embed"])
    else:
        logits = torch.einsum("...d,dv->...v", x, params["lm_head"])
    logits = logits.float()
    if cfg.padded_vocab > cfg.vocab_size:  # mask padding rows
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, L.NEG_INF, logits)
    return logits


# ================================================================== forwards
def _mlp_sublayer(lp, x, cfg):
    """norm2, then the MLP or the MoE layer, then the residual. Returns
    (x, aux): the MoE's load-balance loss, 0.0 for an MLP."""
    h = L.apply_norm(lp["norm2"], x, cfg)
    if "moe" in lp:
        h, aux = MOE.apply_moe(lp["moe"], h, cfg)
    else:
        h, aux = L.apply_mlp(lp["mlp"], h, cfg), 0.0
    return x + h, aux


def _layer_slice(tree, i):
    return {k: _layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _cache_meta(cache, positions):
    """slots [B,S] and the updated key positions [B,M] (``cache
    ["positions"]``, written in place).

    Ring buffers (prefill longer than the cache) keep only the LAST M
    tokens: the reference sends the earlier tokens to the out-of-bounds
    slot M and drops them; here only the trailing M columns are written
    (``layers.apply_gqa`` applies the same rule to the K/V write).
    """
    B, S = positions.shape
    kpos = cache["positions"]
    M = kpos.shape[1]
    slots = positions.long() % M
    s0 = max(S - M, 0)
    bidx = torch.arange(B, device=positions.device)[:, None]
    kpos[bidx, slots[:, s0:]] = positions[:, s0:].to(kpos.dtype)
    return slots, kpos


def _forward_decoder(params, cfg, tokens, positions, cache, mode, window,
                     last_idx=None):
    """Dense / moe / vlm decoder: train, prefill (attend fresh, write the
    cache on the side) or decode (write, then attend the cache). An MoE
    layer dispatches over all B x S tokens, a bucket's padding included,
    as the reference does."""
    has_cache = cache is not None
    x = embed_tokens(params, cfg, tokens)
    if not cfg.use_rope:
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    slots = kpos = None
    if has_cache:
        slots, kpos = _cache_meta(cache, positions)
    rope = (L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if cfg.use_rope else None)
    aux = 0.0
    for i in range(cfg.num_layers):
        lp = _layer_slice(params["layers"], i)
        lc = ({"k": cache["layers"]["k"][i], "v": cache["layers"]["v"][i]}
              if has_cache else None)
        h = L.apply_norm(lp["norm1"], x, cfg)
        h, _ = L.apply_gqa(lp["attn"], h, cfg, positions=positions,
                           cache=lc, slots=slots, k_positions=kpos,
                           window=window, attend_fresh=(mode == "prefill"),
                           rope=rope)
        x = x + h
        x, a = _mlp_sublayer(lp, x, cfg)
        aux = aux + a

    new_cache = None
    if has_cache:
        new_cache = dict(cache, positions=kpos,
                         length=(positions[:, -1] + 1).to(torch.int32))
    if mode == "train":
        return unembed(params, cfg, x), None, aux
    if last_idx is not None:
        # per-row last REAL token (power-of-two padded prefill buckets:
        # causality keeps positions <= last_idx untouched by the padding)
        x_last = x[torch.arange(x.shape[0], device=x.device), last_idx.long()]
    else:
        x_last = x[:, -1]
    return unembed(params, cfg, x_last), new_cache, aux


def forward_paged(params, cfg: ModelConfig, tokens, cache, *, window=None,
                  attn_impl="gather"):
    """Single-token decode step against a PAGED KV pool.

    tokens: [B, 1] on the pool's device. ``cache`` is the paged handle:

    * ``k``/``v``: [L, n_blocks + 1, KV, bs, hd] block pools on the
      device (KV-head-major; the last block is the scratch block that
      takes dropped writes), updated in place
    * ``block_tables``: [B, max_blocks] int (-1 = unallocated)
    * ``lengths``: [B] int tokens already in the pool per slot
    * ``active``: [B] bool (inactive slots decode garbage; their pool
      writes land in the scratch block)

    Every operand lies on the pool's device, and the step takes no host
    array and makes no host sync, so a CUDA graph can capture it
    (serving/graphs.py). The pool-write index, lengths, int32 tables and
    rope's tables are computed once per step, at fixed shapes, for every
    layer. An MoE layer dispatches ``"auto"``, as the reference's paged
    step does. Returns (logits [B, Vpad], new_cache, aux).
    """
    if not cfg.supports_paged_kv:
        raise ValueError(f"paged decode needs a GQA attention decoder "
                         f"(family={cfg.family}, attn={cfg.attention_kind})")
    check_supported(cfg)
    dev = cache["k"].device
    operands = (tokens, cache["block_tables"], cache["lengths"],
                cache["active"])
    if any(t.device != dev for t in operands):
        raise ValueError(f"forward_paged: tokens, block_tables, lengths and "
                         f"active must lie on the pool's device {dev}")
    n_blocks, bs = cache["k"].shape[1] - 1, cache["k"].shape[3]
    lengths = cache["lengths"].to(torch.int32)
    active = cache["active"].bool()
    positions = lengths[:, None]                       # [B, 1]
    meta = L.paged_step_meta(positions, cache["block_tables"], active,
                             n_blocks, bs)
    rope = (L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if cfg.use_rope else None)

    x = embed_tokens(params, cfg, tokens)
    if not cfg.use_rope:
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    aux = 0.0
    for i in range(cfg.num_layers):
        lp = _layer_slice(params["layers"], i)
        h = L.apply_norm(lp["norm1"], x, cfg)
        h, _, _ = L.apply_gqa_paged(
            lp["attn"], h, cfg, positions=positions, pool_k=cache["k"][i],
            pool_v=cache["v"][i], block_tables=meta["tables"], active=active,
            window=window, impl=attn_impl, meta=meta, rope=rope)
        x = x + h
        x, a = _mlp_sublayer(lp, x, cfg)
        aux = aux + a
    new_cache = dict(cache, lengths=lengths + active.to(torch.int32))
    return unembed(params, cfg, x[:, -1]), new_cache, aux


def forward(params, cfg: ModelConfig, tokens, positions=None, cache=None, *,
            mode="train", window=None, last_idx=None):
    """Dense-cache entry point (the paged decode step is
    ``forward_paged``). tokens [B,S] int; positions [B,S] absolute
    (default arange). An MoE layer dispatches ``"auto"``.
    Returns (logits, new_cache, aux_loss):
    train -> full-seq logits [B,S,Vpad]; prefill/decode -> last-token
    [B,Vpad]. ``last_idx`` [B] selects each row's last REAL token instead
    of column -1."""
    check_supported(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    return _forward_decoder(params, cfg, tokens, positions, cache, mode,
                            window, last_idx=last_idx)
