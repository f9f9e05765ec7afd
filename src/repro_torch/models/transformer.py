"""Decoder stacks of every family the JAX package serves: the GQA and MLA
decoders (dense, MoE, VLM), SSM (Mamba2), hybrid (Zamba2) and the audio
encoder-decoder (whisper): prefill/decode over a dense cache, and the GQA
decoders' single-token decode over a paged block pool, with and without
sharding rules.

PyTorch counterpart of ``repro.models.transformer``: ``dense``, ``moe``
and ``vlm`` decoders with GQA or MLA attention (an MoE layer takes the
MLP's place, ``models/moe.py``; MLA caches the compressed latent ``c``
and the shared rope key ``kr``), ``ssm`` (a stack of Mamba2 mixers,
``models/ssm.py``), ``hybrid`` (blocks of Mamba2 layers, each block
followed by one SHARED attention + MLP block, then a tail of Mamba2
layers) and ``audio`` (a non-causal encoder over precomputed frames,
then a decoder whose layers add cross-attention over the encoder's
output; the cross K/V are computed at prefill and cached). Parameters
are a nested dict with the reference's keys and the stacked ``[L, ...]``
layer layout (the hybrid's ``blocks`` are ``[nb, every, ...]``), so
``bridge.params_from_numpy`` maps the JAX tree key for key; the stacks
run as Python loops over layers.

Cache tensors (the dense cache's K/V or latents, positions, length and
SSM states, the paged pool) are updated IN PLACE, where the reference
rebuilt them functionally.

Under sharding rules (``parallel.sharding.use_rules``) ``forward`` runs
one rank's part of the reference's sharded serving or train step for
every family: a vocab-split embedding (a masked lookup and a ``psum``)
and logits (an all-gather), the layers at the rank's shard
(``models/layers.py``, ``models/moe.py``, ``models/ssm.py``; the audio
encoder over the rank's rows of the frames) and its cache shard
(``init_cache_shard``); the collectives carry their backward
(``parallel.mesh``), where the replicated final norm enters a
vocab-split ``lm_head`` or tied table. ``forward_paged`` runs a rank's
part of the paged decode step alike, over its rows and its own pool
(``serving.paged_kv.init_paged_shard``). A decode of S > 1 tokens over
a sequence-split cache attends by distributed flash-decoding partials,
one query row each (``layers.apply_gqa``, ``apply_mla_decode``).

Two routes pick kernels where the reference computes plainly, the same
function held to the same computation: ``attn_impl="kernel"`` sends a
dense-cache decode step's GQA attention, and a single-token query's
cross-attention over the cached encoder K/V, through the
decode-attention kernel (``layers.apply_gqa``), and ``ssd_impl="kernel"``
a prefill's SSD scan from the zero state through the SSD kernel
(``kernels.ops.ssd``). Their defaults, ``"gather"`` and ``"chunked"``,
are the reference's plain computations. MLA attends plainly on every
route, as the reference does.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.parallel import sharding as SH

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


FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def check_supported(cfg: ModelConfig):
    """Raise ValueError for a family the reference does not know either;
    the port covers all of the reference's (``FAMILIES``), GQA and MLA
    attention alike, with and without sharding rules: every family's
    ``forward`` in each mode (a multi-token decode over a
    sequence-split cache included) and the GQA decoders' paged step
    (``forward_paged``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


# ======================================================================= init
def _stacked(lead, make):
    """``make()`` drawn once per index of ``lead`` and stacked into
    ``[*lead, ...]`` leaves, one layer at a time: a full-width stack
    drawn whole would need fp32 temporaries of its size."""
    n = math.prod(lead)
    first = make()
    out = _tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                          device=t.device), first)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    put(out, first, 0)
    for i in range(1, n):
        put(out, make(), i)
    return _tree_map(lambda t: t.view(*lead, *t.shape[1:]), out)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _init_mamba_layer(cfg, gen, dtype):
    return {"norm": L.init_norm(cfg, dtype, gen.device),
            "mixer": SSM.init_mamba2(cfg, gen, dtype)}


def _init_attn(cfg, gen, dtype, lead):
    if cfg.attention_kind == "mla":
        return L.init_mla(cfg, gen, dtype, lead=lead)
    return L.init_gqa(cfg, gen, dtype, lead=lead)


def _init_enc_layers(cfg, gen, dtype, lead):
    """The audio encoder's layers: self-attention and a GELU MLP."""
    dev = gen.device
    return {"norm1": L.init_norm(cfg, dtype, dev, lead=lead),
            "attn": L.init_gqa(cfg, gen, dtype, lead=lead),
            "norm2": L.init_norm(cfg, dtype, dev, lead=lead),
            "mlp": L.init_mlp(cfg, gen, dtype, lead=lead)}


def _init_encdec_layers(cfg, gen, dtype, lead):
    """The audio decoder's layers: an encoder layer with cross-attention
    (``norm_x``, ``xattn``) between its attention and its MLP."""
    p = _init_enc_layers(cfg, gen, dtype, lead)
    p["norm_x"] = L.init_norm(cfg, dtype, gen.device, lead=lead)
    p["xattn"] = L.init_gqa(cfg, gen, dtype, lead=lead)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype="bfloat16"):
    """Random weights from ``gen`` (on ``gen.device``), with the reference
    tree's keys and shapes; the same distributions as the reference
    (scaled normal embedding, truncated-normal fan-in dense layers). An
    MoE config gets ``layers["moe"]`` in place of ``layers["mlp"]``, as
    the reference's ``_init_decoder_layer`` builds it. An SSM config gets
    ``layers`` of Mamba2 layers (``norm``, ``mixer``); a hybrid config
    ``blocks`` ``[nb, every, ...]`` of them, a ``tail`` of the
    remaining ``num_layers % every`` where there are any, and the
    ``shared`` attention block (with its ``mlp`` when the config has a
    ``d_ff``). Mamba2 layers are drawn one at a time into ``dtype``, and
    every other leaf a layer's slice at a time (``layers.draw_into``). An
    MLA config's attention is ``layers.init_mla``'s; an audio config gets
    decoder ``layers`` with cross-attention and an ``encoder`` of
    ``num_encoder_layers`` layers and its ``final_norm``."""
    check_supported(cfg)
    dtype = torch_dtype(dtype)
    dev = gen.device
    lead = (cfg.num_layers,)
    embed = L.new_leaf((cfg.padded_vocab, cfg.d_model), dtype, dev)
    params = {
        "embed": L.draw_into(embed, lambda t: t.normal_(generator=gen),
                             1.0 / math.sqrt(cfg.d_model)),
        "final_norm": L.init_norm(cfg, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         dtype)
    mamba = functools.partial(_init_mamba_layer, cfg, gen, dtype)
    if cfg.family == "ssm":
        params["layers"] = _stacked(lead, mamba)
        return params
    if cfg.family == "hybrid":
        nb, rem = divmod(cfg.num_layers, cfg.hybrid_attn_every)
        params["blocks"] = _stacked((nb, cfg.hybrid_attn_every), mamba)
        if rem:
            params["tail"] = _stacked((rem,), mamba)
        params["shared"] = {
            "norm1": L.init_norm(cfg, dtype, dev),
            "attn": L.init_gqa(cfg, gen, dtype),
            "norm2": L.init_norm(cfg, dtype, dev),
        }
        if cfg.d_ff:
            params["shared"]["mlp"] = L.init_mlp(cfg, gen, dtype)
        return params
    if cfg.family == "audio":
        params["layers"] = _init_encdec_layers(cfg, gen, dtype, lead)
        params["encoder"] = {
            "layers": _init_enc_layers(cfg, gen, dtype,
                                       (cfg.num_encoder_layers,)),
            "final_norm": L.init_norm(cfg, dtype, dev),
        }
        return params
    params["layers"] = {
        "norm1": L.init_norm(cfg, dtype, dev, lead=lead),
        "attn": _init_attn(cfg, gen, dtype, lead),
        "norm2": L.init_norm(cfg, dtype, dev, lead=lead),
    }
    if cfg.num_experts > 0:
        params["layers"]["moe"] = MOE.init_moe(cfg, gen, dtype, lead=lead)
    else:
        params["layers"]["mlp"] = L.init_mlp(cfg, gen, dtype, lead=lead)
    return params


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` reads ``meta``: ``init_params``
    allocates on ``gen.device``, and a draw into a meta tensor reads no
    generator state."""
    device = torch.device("meta")


def init_params_meta(cfg: ModelConfig, dtype="bfloat16"):
    """``init_params``' tree as meta tensors: every shape and type,
    nothing allocated (the reference's ``jax.eval_shape(init_params)``)."""
    return init_params(cfg, _MetaGenerator(), dtype)


def init_params_shard(cfg: ModelConfig, gen: torch.Generator, rules, mesh,
                      dtype="bfloat16"):
    """This rank's shard of ``init_params(cfg, gen, dtype)`` under
    ``parallel.sharding.param_specs(cfg, ·, rules, mesh)``, bit for bit
    the leaves of ``shard_params`` of that draw, without ever holding the
    whole tree: every rank draws the whole stream from ``gen`` (seeded
    alike on every rank), the same calls in the same order, and each leaf
    drawn by ``layers.draw_into`` keeps only this rank's part of each
    fp32 chunk as it is drawn (``parallel.sharding.ShardDraw``). The
    peak is this rank's shards, one fp32 chunk (at most one layer's
    slice of a leaf, ``layers.DRAW_ELEMS``) and the leaves drawn whole:
    the norms, and the pieces a draw copies into a leaf (an MoE's
    experts, a Mamba2 stack's layers), which are then sliced. A first
    pass on the meta device records the draw's allocations and maps each
    to its leaf's spec."""
    record = SH.ShardDraw()
    with L.drawing_shards(record):
        meta = init_params(cfg, _MetaGenerator(), dtype)
    specs = SH.param_specs(cfg, meta, rules, mesh)
    spec_of = {}
    SH.tree_map(lambda leaf, spec: spec_of.setdefault(
        id(leaf if leaf._base is None else leaf._base), spec), meta, specs)
    sink = SH.ShardDraw([(tuple(w.shape), spec_of.get(id(w)))
                         for w in record.allocated], mesh, gen.device)
    del meta
    with L.drawing_shards(sink):
        tree = init_params(cfg, gen, dtype)
    if sink.done != len(sink.plan):
        raise RuntimeError(f"the draw made {sink.done} of the "
                           f"{len(sink.plan)} recorded allocations")

    def shard(x, spec):
        kept = sink.shard_of(x)
        if kept is not None:
            return kept
        if all(a is None for a in spec):    # replicated: the leaf is its shard
            return x
        return SH.shard_leaf(x, spec, mesh)

    return SH.tree_map(shard, tree, specs)


# ====================================================================== cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype="bfloat16",
               device="cuda"):
    """Dense serving cache. ``max_len`` is the capacity per request; a
    sliding-window arch may pass ``min(logical_len, window)`` to get a
    ring buffer. Decoders: K/V ``[L, B, max_len, KV, hd]`` and per-row
    absolute positions (unwritten rows hold BIG_POS so they mask out).
    SSM: the Mamba2 states ``[L, B, ...]`` (the conv histories and the
    SSD state, in ``dtype`` as the reference keeps them), O(1) in
    sequence length. Hybrid: those states as ``blocks`` ``[nb, every,
    B, ...]`` and ``tail`` ``[rem, B, ...]``, the shared block's K/V
    ``[nb, B, max_len, KV, hd]`` (one per application) and positions.
    MLA: the latents ``c`` ``[L, B, max_len, kv_rank]`` and ``kr`` ``[L,
    B, max_len, rope]`` in place of K/V. Audio: the decoder's K/V and the
    ``cross`` K/V ``[L, B, encoder_seq_len, KV, hd]``."""
    check_supported(cfg)
    dtype = torch_dtype(dtype)
    hd = cfg.resolved_head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(n_layers, n_ctx=max_len):
        shape = (n_layers, batch, n_ctx, cfg.num_kv_heads, hd)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    def ssm_state(*lead):
        K1 = cfg.ssm_conv_dim - 1
        gN = cfg.ssm_ngroups * cfg.ssm_state
        return {"conv_x": zeros(*lead, batch, K1, cfg.ssm_d_inner),
                "conv_B": zeros(*lead, batch, K1, gN),
                "conv_C": zeros(*lead, batch, K1, gN),
                "ssd": zeros(*lead, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state)}

    def positions():
        return torch.full((batch, max_len), BIG_POS, dtype=torch.int32,
                          device=device)

    cache = {"length": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}
    if cfg.family == "ssm":
        cache["layers"] = ssm_state(cfg.num_layers)
    elif cfg.family == "hybrid":
        nb, rem = divmod(cfg.num_layers, cfg.hybrid_attn_every)
        cache["positions"] = positions()
        cache["blocks"] = ssm_state(nb, cfg.hybrid_attn_every)
        if rem:
            cache["tail"] = ssm_state(rem)
        cache["shared"] = kv(nb)
    else:
        cache["positions"] = positions()
        if cfg.attention_kind == "mla":
            L_ = cfg.num_layers
            cache["layers"] = {
                "c": zeros(L_, batch, max_len, cfg.kv_lora_rank),
                "kr": zeros(L_, batch, max_len, cfg.qk_rope_head_dim)}
        else:
            cache["layers"] = kv(cfg.num_layers)
        if cfg.family == "audio":
            cache["cross"] = kv(cfg.num_layers, cfg.encoder_seq_len)
    return cache


def init_cache_shard(cfg: ModelConfig, batch: int, max_len: int, rules,
                     mesh, dtype="bfloat16", device="cuda"):
    """This rank's shard of ``init_cache(cfg, batch, max_len)`` under
    ``parallel.sharding.cache_specs(rules)``, allocated at its local
    shape (the whole cache is never made): its rows of the batch, its
    slots of a sequence-split cache (never the audio ``cross`` K/V's),
    its KV heads, its SSM heads of the Mamba2 states ``conv_x`` and
    ``ssd`` (``conv_B`` / ``conv_C`` whole)."""
    full = init_cache(cfg, batch, max_len, dtype, device="meta")
    local = SH.shard_params(full, SH.cache_specs(full, rules), mesh)
    return SH.tree_map_with_path(
        lambda path, t: torch.full(t.shape, BIG_POS if path[-1] == "positions"
                                   else 0, dtype=t.dtype, device=device),
        local)


# ================================================================= embeddings
def embed_tokens(params, cfg: ModelConfig, tokens):
    """Token ids must lie below the vocab size: ``jnp.take`` clamps an
    out-of-range id, torch indexing on the card traps. The engine checks
    prompts at submission, and sampled ids are below the vocab size.
    A vocab-split table (sharding rules) looks up the ids this rank holds
    (zeros for the others) and sums across the ``vocab`` axis."""
    emb = params["embed"]
    axis = L.split_axis("vocab", emb.shape[0], cfg.padded_vocab)
    if axis is None:
        x = emb[tokens]
    else:
        mesh = L.rule_mesh(SH.current_rules())
        ids = tokens - mesh.axes_index(axis) * emb.shape[0]
        own = (ids >= 0) & (ids < emb.shape[0])
        x = emb[ids.clamp(0, emb.shape[0] - 1)] * own[..., None].to(emb.dtype)
        x = mesh.psum(x, axis)
    if cfg.scale_embed:
        # the factor rounds to x's type first, as in the reference;
        # torch.full fills on the device (no host->device copy)
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


def unembed(params, cfg: ModelConfig, x):
    """Final norm and the logits over the padded vocabulary (padding
    columns masked). A vocab-split ``lm_head`` (or tied table) gives this
    rank's columns, gathered across the ``vocab`` axis."""
    x = L.apply_norm(params["final_norm"], x, cfg)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    n_local = table.shape[0 if cfg.tie_embeddings else 1]
    x = L.enter_split(x, "vocab", n_local, cfg.padded_vocab)
    if cfg.tie_embeddings:
        logits = torch.einsum("...d,vd->...v", x, table)
    else:
        logits = torch.einsum("...d,dv->...v", x, table)
    axis = L.split_axis("vocab", n_local, cfg.padded_vocab)
    if axis is not None:
        logits = L.rule_mesh(SH.current_rules()).all_gather(logits, axis, -1)
    logits = logits.float()
    if cfg.padded_vocab > cfg.vocab_size:  # mask padding rows
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, L.NEG_INF, logits)
    return logits


# ================================================================== forwards
def _mlp_sublayer(lp, x, cfg, layer_hook=None, dispatch="auto"):
    """norm2, then the MLP or the MoE layer (``dispatch``), then the
    residual. Returns (x, aux): the MoE's load-balance loss, 0.0 for an
    MLP. Under a ``layer_hook`` an MoE layer takes the full batch (its
    capacity and loss are over every row, as the reference's sharded
    layer computes them)."""
    if "moe" in lp and layer_hook is not None:
        x = layer_hook.full(x)
    h = L.apply_norm(lp["norm2"], x, cfg)
    if "moe" in lp:
        h, aux = MOE.apply_moe(lp["moe"], h, cfg, dispatch=dispatch)
    else:
        h, aux = L.apply_mlp(lp["mlp"], h, cfg), 0.0
    return x + h, aux


def _layer_slice(tree, i):
    return _tree_map(lambda t: t[i], tree)


def _per_layer(tree, train):
    """Layer ``i``'s tree of a stacked tree, as a function of ``i``. In
    train mode every stacked leaf is unbound once (``unbind(0)``), so
    autograd stacks its gradient once: a ``t[i]`` per layer gives each
    layer's backward a zero tensor the size of the whole stack."""
    if not train:
        return functools.partial(_layer_slice, tree)
    parts = _tree_map(lambda t: t.unbind(0), tree)
    return lambda i: _tree_map(lambda u: u[i], parts)


def _remat(fn, remat):
    """``fn``, or with ``remat`` ``fn`` under activation checkpointing
    (``torch.utils.checkpoint``, non-reentrant): the backward recomputes
    its activations instead of keeping them, as ``jax.checkpoint`` does
    for the reference's layer bodies."""
    if not remat:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _write_state(lc, new):
    """A Mamba2 layer's new states into its cache leaves, in place (the
    mixer returns new tensors; the cache's tensors never move)."""
    for k, t in new.items():
        lc[k].copy_(t)


def _set_length(cache, positions):
    cache["length"].copy_(positions[:, -1] + 1)
    return cache


def _cache_meta(cache, positions):
    """slots [B,S] and the updated key positions [B,M] (``cache
    ["positions"]``, written in place).

    Ring buffers (prefill longer than the cache) keep only the LAST M
    tokens: the reference sends the earlier tokens to the out-of-bounds
    slot M and drops them; here only the trailing M columns are written
    (``layers.write_slots``, also the K/V write's rule). Slots are the
    whole cache's: a rank holding a slice of a sequence-split cache
    writes the slots it holds.
    """
    kpos = cache["positions"]
    M, _, _ = L.cache_span(kpos.shape[1])
    slots = positions.long() % M
    L.write_slots(kpos, slots, positions)
    return slots, kpos


def _attn(lp, h, cfg, positions, lc, slots, kpos, mode, window, rope,
          attn_impl):
    """A decoder layer's self-attention: MLA's absorbed form in decode
    mode and its expanded form otherwise, or GQA (prefill attends the
    fresh sequence and writes the cache on the side; decode writes, then
    attends the cache)."""
    if cfg.attention_kind == "mla":
        if mode == "decode":
            return L.apply_mla_decode(lp["attn"], h, cfg, positions=positions,
                                      cache=lc, slots=slots, k_positions=kpos,
                                      window=window, rope=rope)[0]
        return L.apply_mla_prefill(lp["attn"], h, cfg, positions=positions,
                                   cache=lc, slots=slots, window=window,
                                   rope=rope)[0]
    return L.apply_gqa(lp["attn"], h, cfg, positions=positions, cache=lc,
                       slots=slots, k_positions=kpos, window=window,
                       attend_fresh=(mode == "prefill"), rope=rope,
                       impl=attn_impl)[0]


def _cross_cache(cache, enc_out, params):
    """The cache's ``cross`` leaves, ready to take a prefill's cross K/V.
    They keep the type ``compute_cross_kv`` gives them, as the
    reference's prefill returns them: fp32 frames through bf16 weights
    give fp32 K/V, which the extensions of a chunked prefill read before
    ``kvcache.insert_request`` narrows them into the engine's cache. Where
    that type is not the cache's, the leaves are replaced at their own
    shape, a rank's shard under sharding rules (a prefill's throwaway
    cache; no graph reads it)."""
    cross = cache["cross"]
    dt = torch.promote_types(enc_out.dtype,
                             params["layers"]["xattn"]["wk"].dtype)
    if cross["k"].dtype != dt:
        cross = cache["cross"] = {n: torch.empty(t.shape, dtype=dt,
                                                 device=t.device)
                                  for n, t in cross.items()}
    return cross


def _forward_decoder(params, cfg, tokens, positions, cache, mode, window,
                     last_idx=None, attn_impl="gather", encoder_out=None,
                     layer_hook=None, dispatch="auto", remat=False):
    """Dense / moe / vlm decoder and the whisper decoder: train, prefill
    (attend fresh, write the cache on the side) or decode (write, then
    attend the cache). An MoE layer dispatches over all B x S tokens, a
    bucket's padding included, as the reference does. Rope's tables are
    built once per call at the width attention rotates: MLA's rope dim,
    else the head dim. Audio: a train or prefill call attends the cross
    K/V computed from ``encoder_out`` (a prefill also stores them in the
    cache's ``cross`` leaves); a decode call reads them from the cache.
    ``layer_hook`` (a cache-less call) splits each layer's batch
    (``core.replication.LayerHook``). ``remat`` (train mode) checkpoints
    each layer's body, as the reference's ``jax.checkpoint`` does."""
    has_cache = cache is not None
    train = mode == "train"
    is_audio = cfg.family == "audio"
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    if not cfg.use_rope:
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    slots = kpos = None
    if has_cache:
        slots, kpos = _cache_meta(cache, positions)
    rope_dim = (cfg.qk_rope_head_dim if cfg.attention_kind == "mla"
                else cfg.resolved_head_dim)
    rope = (L.rope_tables(positions, rope_dim, cfg.rope_theta)
            if cfg.use_rope else None)
    cross = cross_len = None
    if is_audio and mode == "decode":
        cross = cache["cross"]
    elif is_audio and has_cache:
        cross = _cross_cache(cache, encoder_out, params)
    if is_audio and attn_impl == "kernel" and S == 1:
        # the cross-attention kernel's lengths, once per call, fixed shape
        n_enc = (cross["k"].shape[2] if mode == "decode"
                 else encoder_out.shape[1])
        cross_len = torch.full((B,), n_enc, dtype=torch.int32,
                               device=x.device)

    def layer(x, lp, lc, pos_i, rope_i, i):
        h = L.apply_norm(lp["norm1"], x, cfg)
        x = x + _attn(lp, h, cfg, pos_i, lc, slots, kpos, mode, window,
                      rope_i, attn_impl)
        if is_audio:
            if mode == "decode":
                ckv = (cross["k"][i], cross["v"][i])
            else:
                ckv = L.compute_cross_kv(lp["xattn"], encoder_out, cfg)
                if cross is not None:
                    cross["k"][i].copy_(ckv[0])
                    cross["v"][i].copy_(ckv[1])
            h = L.apply_norm(lp["norm_x"], x, cfg)
            x = x + L.apply_gqa(lp["xattn"], h, cfg, positions=positions,
                                kv_override=ckv, impl=attn_impl,
                                kv_lengths=cross_len)[0]
        return _mlp_sublayer(lp, x, cfg, layer_hook, dispatch)

    body = _remat(layer, remat and train)
    layer_params = _per_layer(params["layers"], train)
    aux = 0.0
    pos_i, rope_i = positions, rope
    for i in range(cfg.num_layers):
        lc = _layer_slice(cache["layers"], i) if has_cache else None
        if layer_hook is not None:
            x = layer_hook(i, x)
            pos_i, rope_i = layer_hook.rows(positions), layer_hook.rows(rope)
        x, a = body(x, layer_params(i), lc, pos_i, rope_i, i)
        aux = aux + a
    if layer_hook is not None:
        x = layer_hook.full(x)

    new_cache = _set_length(cache, positions) if has_cache else None
    if train:
        return unembed(params, cfg, x), None, aux
    if last_idx is not None:
        # per-row last REAL token (power-of-two padded prefill buckets:
        # causality keeps positions <= last_idx untouched by the padding)
        x_last = x[torch.arange(x.shape[0], device=x.device), last_idx.long()]
    else:
        x_last = x[:, -1]
    return unembed(params, cfg, x_last), new_cache, aux


def encode_audio(params, cfg: ModelConfig, frames, train=False):
    """Whisper-style encoder over precomputed (stubbed) frame embeddings
    [B, S, d]: sinusoidal positions, ``num_encoder_layers`` non-causal
    layers, the final norm. It runs in the frames' type promoted with the
    weights' (fp32 frames through bf16 weights run in fp32, as in the
    reference). ``train``: the layers' stacks are unbound once
    (``_per_layer``); the reference does not checkpoint the encoder.
    Under sharding rules ``frames`` are this rank's rows (the reference's
    ``batch_specs(with_frames=True)``) and the layers run at its
    heads and ``d_ff`` slice."""
    B, S, _ = frames.shape
    pos = torch.arange(S, dtype=torch.int32, device=frames.device).expand(B, S)
    x = frames + L.sinusoidal_positions(pos, cfg.d_model).to(frames.dtype)
    enc = params["encoder"]
    layer_params = _per_layer(enc["layers"], train)
    for i in range(cfg.num_encoder_layers):
        lp = layer_params(i)
        h = L.apply_norm(lp["norm1"], x, cfg)
        x = x + L.apply_gqa(lp["attn"], h, cfg, positions=pos,
                            causal=False)[0]
        h = L.apply_norm(lp["norm2"], x, cfg)
        x = x + L.apply_mlp(lp["mlp"], h, cfg)
    return L.apply_norm(enc["final_norm"], x, cfg)


def _mamba_layer(lp, x, cfg, lc, mode, ssd_fn):
    """One Mamba2 layer (norm, mixer, residual). A single-token decode
    steps the recurrence; a prefill scans from the zero state (the
    engine's prefill cache is fresh, so its states are zero: ``state=
    None`` is the same scan, and the SSD kernel's case); a multi-token
    decode (a chunked prefill's extension) continues from the cache's
    states. New states are written into ``lc`` in place."""
    h = L.apply_norm(lp["norm"], x, cfg)
    if mode == "decode" and x.shape[1] == 1:
        h, ns = SSM.apply_mamba2_decode(lp["mixer"], h, cfg, state=lc)
    else:
        state = lc if mode == "decode" else None
        h, ns = SSM.apply_mamba2(lp["mixer"], h, cfg, state=state,
                                 ssd_fn=ssd_fn)
    if lc is not None:
        _write_state(lc, ns)
    return x + h


def _ssd_fn(ssd_impl):
    if ssd_impl not in ("kernel", "chunked"):
        raise ValueError(f"unknown ssd_impl {ssd_impl!r}")
    return ops.ssd if ssd_impl == "kernel" else SSM.ssd_chunked


def _last(params, cfg, x, mode):
    if mode == "train":
        return unembed(params, cfg, x)
    return unembed(params, cfg, x[:, -1])


def _forward_ssm(params, cfg, tokens, positions, cache, mode, ssd_fn,
                 remat=False):
    train = mode == "train"
    x = embed_tokens(params, cfg, tokens)
    body = _remat(lambda x, lp, lc: _mamba_layer(lp, x, cfg, lc, mode, ssd_fn),
                  remat and train)
    layer_params = _per_layer(params["layers"], train)
    for i in range(cfg.num_layers):
        lc = _layer_slice(cache["layers"], i) if cache is not None else None
        x = body(x, layer_params(i), lc)
    new_cache = _set_length(cache, positions) if cache is not None else None
    return _last(params, cfg, x, mode), new_cache, 0.0


def _forward_hybrid(params, cfg, tokens, positions, cache, mode, window,
                    ssd_fn, attn_impl, remat=False):
    """Blocks of ``every`` Mamba2 layers, each followed by the SHARED
    attention (+ MLP) block (the same parameters every time, its own K/V
    per application), then the tail of Mamba2 layers. ``remat`` (train
    mode) checkpoints each block, not the tail, as the reference does."""
    train = mode == "train"
    every = cfg.hybrid_attn_every
    nb, rem = divmod(cfg.num_layers, every)
    has_cache = cache is not None
    x = embed_tokens(params, cfg, tokens)
    slots = kpos = None
    if has_cache:
        slots, kpos = _cache_meta(cache, positions)
    rope = (L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if cfg.use_rope else None)
    shared = params["shared"]

    def mamba(x, lp, part, idx):
        lc = _layer_slice(cache[part], idx) if has_cache else None
        return _mamba_layer(lp, x, cfg, lc, mode, ssd_fn)

    def block(x, bp, b):
        layer_params = _per_layer(bp, train)
        for j in range(every):
            x = mamba(x, layer_params(j), "blocks", (b, j))
        h = L.apply_norm(shared["norm1"], x, cfg)
        skv = ({"k": cache["shared"]["k"][b], "v": cache["shared"]["v"][b]}
               if has_cache else None)
        h, _ = L.apply_gqa(shared["attn"], h, cfg, positions=positions,
                           cache=skv, slots=slots, k_positions=kpos,
                           window=window, attend_fresh=(mode == "prefill"),
                           rope=rope, impl=attn_impl)
        x = x + h
        if "mlp" in shared:
            h = L.apply_norm(shared["norm2"], x, cfg)
            x = x + L.apply_mlp(shared["mlp"], h, cfg)
        return x

    body = _remat(block, remat and train)
    block_params = _per_layer(params["blocks"], train)
    for b in range(nb):
        x = body(x, block_params(b), b)
    if rem:
        tail_params = _per_layer(params["tail"], train)
        for i in range(rem):
            x = mamba(x, tail_params(i), "tail", i)
    new_cache = _set_length(cache, positions) if has_cache else None
    return _last(params, cfg, x, mode), new_cache, 0.0


def _paged_rows(hook, positions, meta, active, rope):
    """A paged layer's operands at the hook's current degree: this rank's
    rows of the positions, lengths, tables, ``active`` and rope tables
    (padding rows inactive, length 0, no blocks), the full batch's write
    indices, and the K/V gather of a replicated layer (None at degree
    1)."""
    if hook.degree == 1:
        return positions, meta, active, rope, None
    rows = dict(meta, kv_len=hook.rows(meta["kv_len"]),
                tables=hook.rows(meta["tables"], -1))
    return (hook.rows(positions), rows, hook.rows(active, False),
            hook.rows(rope), hook.gather_kv)


def forward_paged(params, cfg: ModelConfig, tokens, cache, *, window=None,
                  attn_impl="gather", layer_hook=None, dispatch="auto"):
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
    step does (``dispatch`` picks another, ``moe.apply_moe``'s).
    ``layer_hook`` (``core.replication.LayerHook``, the live
    engine's replication plan) splits each layer's batch: a replicated
    layer attends with this rank's rows, their tables, lengths and
    ``active``, and writes every row's K/V (``LayerHook.gather_kv``),
    so every rank's pool stays a full replica; the logits are the full
    batch's on every rank.

    Under sharding rules (``parallel.sharding.use_rules``, the
    reference's ``lshard(x, "batch", "seq", None)``) it runs one rank's
    part of the reference's paged step; every rank of the mesh calls it
    together. ``params`` is this rank's ``shard_params`` tree;
    ``tokens``, ``block_tables``, ``lengths`` and ``active`` are its rows
    under ``rules["batch"]``; ``k`` / ``v`` are its own pool
    (``serving.paged_kv.init_paged_shard``), ``[L, n_blocks + 1,
    KV_local, bs, hd]``, holding its rows' blocks (its tables index it)
    at its KV heads where ``kv_heads`` splits them, else at every KV
    head. The reference's ``cache_specs`` has no paged entry and its
    pool is a plain operand, so a pool is never split over its blocks:
    ``cache_seq`` does not apply to it. The layers run at the rank's
    heads with a row-parallel ``wo`` (``layers.apply_gqa_paged``), the
    embedding and logits over the vocab split, the MLP over its ``d_ff``
    slice and an MoE layer's ``"auto"`` dispatch under the rules (the
    expert-parallel one under ``moe_a2a``). The step stays shape-stable
    and makes no host sync beyond its collectives. A ``layer_hook``
    under rules raises: both split the batch, and the reference's engine
    never combines them.
    Returns (logits [B, Vpad], new_cache, aux).
    """
    if not cfg.supports_paged_kv:
        raise ValueError(f"paged decode needs a GQA attention decoder "
                         f"(family={cfg.family}, attn={cfg.attention_kind})")
    check_supported(cfg)
    if layer_hook is not None and SH.current_rules() is not None:
        raise NotImplementedError(
            "a replication layer_hook under sharding rules is not ported "
            "(ROADMAP, after the port: engines across a rank group)")
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
    pos_i, meta_i, act_i, rope_i, kv_rows = positions, meta, active, rope, None
    for i in range(cfg.num_layers):
        lp = _layer_slice(params["layers"], i)
        if layer_hook is not None:
            x = layer_hook(i, x)
            pos_i, meta_i, act_i, rope_i, kv_rows = _paged_rows(
                layer_hook, positions, meta, active, rope)
        h = L.apply_norm(lp["norm1"], x, cfg)
        h, _, _ = L.apply_gqa_paged(
            lp["attn"], h, cfg, positions=pos_i, pool_k=cache["k"][i],
            pool_v=cache["v"][i], block_tables=meta_i["tables"],
            active=act_i, window=window, impl=attn_impl, meta=meta_i,
            rope=rope_i, kv_rows=kv_rows)
        x = x + h
        x, a = _mlp_sublayer(lp, x, cfg, layer_hook, dispatch)
        aux = aux + a
    if layer_hook is not None:
        x = layer_hook.full(x)
    new_cache = dict(cache, lengths=lengths + active.to(torch.int32))
    return unembed(params, cfg, x[:, -1]), new_cache, aux


def forward(params, cfg: ModelConfig, tokens, positions=None, cache=None, *,
            mode="train", encoder_input=None, window=None, last_idx=None,
            attn_impl="gather", ssd_impl="chunked", layer_hook=None,
            dispatch="auto", remat=False):
    """Uniform entry point. A paged handle (a ``cache`` holding
    ``block_tables``) takes the paged decode step, ``forward_paged``
    (decode mode only, ``positions`` read from the handle's lengths), as
    in the reference, under sharding rules too. tokens [B,S] int;
    positions [B,S] absolute (default arange). An MoE layer dispatches
    ``"auto"``.
    Returns (logits, new_cache, aux_loss):
    train -> full-seq logits [B,S,Vpad]; prefill/decode -> last-token
    [B,Vpad]. ``last_idx`` [B] (decoders only, as in the reference)
    selects each row's last REAL token instead of column -1. The cache
    is updated in place and returned. ``attn_impl`` / ``ssd_impl``: the
    kernel routes of the module docstring. ``encoder_input`` [B, S_enc,
    d] (audio, train and prefill modes) are the encoder's frames; a
    decode call reads the cross K/V its prefill cached. ``layer_hook``
    (``core.replication.LayerHook``; a decoder's cache-less call, as the
    reference's replication tests run it) splits each layer's batch
    between the ranks of its group. ``dispatch`` is the MoE layers'
    (``moe.apply_moe``).

    Train mode takes no cache and the plain routes (``attn_impl`` and
    ``ssd_impl`` at their defaults launch no kernel, and no kernel has a
    backward). ``remat`` checkpoints each layer's body there (a hybrid's
    blocks), as the reference's ``jax.checkpoint`` does; every stacked
    leaf is unbound once per call (``_per_layer``), so its gradient is
    stacked once.

    Under sharding rules (``parallel.sharding.use_rules``, read here as
    the reference reads them) every family runs this rank's shard of the
    reference's sharded step: ``params`` is this rank's
    ``shard_params`` tree, ``tokens`` / ``positions`` (and an audio
    config's ``encoder_input``) its rows under ``rules["batch"]``,
    ``cache`` its shard (``init_cache_shard``); every rank of the mesh
    calls it together, and the logits are every column's on every
    rank.

    Prefill mode starts a sequence: the SSM and hybrid families scan
    from the ZERO state and ignore the states ``cache`` holds (the
    attention already ignores its earlier K/V there). This equals the
    reference, which scans from the cache's states, for a fresh
    (zeroed) cache, the only one the engine prefills; to continue from a
    used cache, call decode mode with the new tokens."""
    check_supported(cfg)
    if attn_impl not in ("kernel", "gather"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if cache is not None and "block_tables" in cache:
        if mode != "decode":
            raise ValueError("a paged cache handle is decode-only")
        return forward_paged(params, cfg, tokens, cache, window=window,
                             attn_impl=attn_impl, layer_hook=layer_hook,
                             dispatch=dispatch)
    if mode == "train" and cache is not None:
        raise ValueError("a train call takes no cache: its in-place writes "
                         "are not differentiable")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    if layer_hook is not None and (
            cache is not None or cfg.family not in ("dense", "moe", "vlm")):
        raise ValueError("layer_hook splits a decoder's cache-less call; "
                         "the paged decode step takes it in forward_paged")
    if layer_hook is not None and SH.current_rules() is not None:
        raise ValueError("layer_hook and sharding rules each split the "
                         "batch: pass one of them")
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        enc_out = None
        if cfg.family == "audio" and mode in ("train", "prefill"):
            if encoder_input is None:
                raise ValueError("audio needs encoder frames "
                                 "(encoder_input) in train and prefill mode")
            enc_out = encode_audio(params, cfg, encoder_input,
                                   train=mode == "train")
        return _forward_decoder(params, cfg, tokens, positions, cache, mode,
                                window, last_idx=last_idx,
                                attn_impl=attn_impl, encoder_out=enc_out,
                                layer_hook=layer_hook, dispatch=dispatch,
                                remat=remat)
    if last_idx is not None:
        raise ValueError(f"last_idx unsupported for family {cfg.family}")
    if cfg.family == "ssm":
        return _forward_ssm(params, cfg, tokens, positions, cache, mode,
                            _ssd_fn(ssd_impl), remat)
    return _forward_hybrid(params, cfg, tokens, positions, cache, mode,
                           window, _ssd_fn(ssd_impl), attn_impl, remat)
