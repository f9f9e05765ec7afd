"""Port parity, a multi-token decode over a sequence-split cache: a
prefill, one decode step and a 4-token extension (decode mode, S = 4)
under sharding rules whose cache splits its sequence (``cache_seq``),
every rank a thread (``_torch_mesh``) with its shard of the weights
(the reference's ``init_params`` draw, ``_torch_sharded.pair``), its
rows and its cache shard, against the reference's UNSHARDED stream on
the same weights (``ref_stream(..., ext=)``): logits of every call
within 1e-4, greedy tokens equal, and the collectives of the decode step
and of the extension each the design's count (flash-decoding's pmax and
two psums an attention layer, whatever S is).

The reference attends the whole cache plainly there and lets GSPMD
gather its keys; the port combines per-row flash-decoding partials and
gathers no cache. Cases: reduced tinyllama under ``long_context_rules``
on a ring its prompt wraps and its extension carries across the two
ranks' halves, with and without ``flash_decode``, and on (2, 2);
minicpm3 (MLA's absorbed form); zamba2's shared block; whisper's
self-attention; a ``rules_for`` mesh whose single KV head does not
divide the model axis (the cache's sequence splits over ``model`` and
the queries are gathered). The partials of S rows are also held against
S single-row calls and the reference's plain attention."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.parallel import distributed_attention as DA
from repro_torch.parallel import sharding as SH
from _torch_mesh import rows, run_mesh
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_sharded import pair, port_stream, ref_stream, tokens

TOL = 1e-4
STEPS, N_EXT = 1, 4


# name -> (arch, changes, mesh, long context, flash_decode, B, prompt, M,
#          window, impl, collectives of one call from the layer count)
CASES = {
    # the ring of 16 slots, 8 a rank: the prompt (20) wraps it, and the
    # extension's slots 5..8 cross from rank 0's half into rank 1's
    "tinyllama-ring-long-2x1-flash": (
        "tinyllama-1.1b", (), (2, 1), True, True, 1, 20, 16, 16, "gather",
        lambda L: {"all-reduce": 3 * L}),
    "tinyllama-ring-long-2x1": (
        "tinyllama-1.1b", (), (2, 1), True, False, 1, 20, 16, 16, "kernel",
        lambda L: {"all-reduce": 3 * L}),
    # heads split over model too: the embedding's psum, wo and w_down,
    # the logits' all-gather besides
    "tinyllama-ring-long-2x2": (
        "tinyllama-1.1b", (), (2, 2), True, True, 1, 20, 16, 16, "gather",
        lambda L: {"all-reduce": 1 + 5 * L, "all-gather": 1}),
    "minicpm3-ring-long-2x1": (
        "minicpm3-4b", (), (2, 1), True, True, 1, 20, 16, 16, "gather",
        lambda L: {"all-reduce": 3 * L}),
    # one shared-block application (3 layers, every 2): its slots 14..19
    # cross the halves at 16
    "zamba2-long-2x1": (
        "zamba2-7b", (("num_layers", 3),), (2, 1), True, True, 1, 14, 32,
        None, "gather", lambda L: {"all-reduce": 3}),
    "whisper-long-2x1": (
        "whisper-medium", (), (2, 1), True, True, 2, 14, 32, None, "kernel",
        lambda L: {"all-reduce": 3 * L}),
    # one KV head on model 2: the cache's sequence splits over model, the
    # queries (all S rows) are gathered over it each attention layer
    "gqa-kv1-1x2": (
        "tinyllama-1.1b", (("num_kv_heads", 1),), (1, 2), False, False, 2,
        14, 32, None, "gather",
        lambda L: {"all-reduce": 1 + 5 * L, "all-gather": 1 + L}),
}


def _enc(tcfg, B):
    if tcfg.family != "audio":
        return None
    return np.random.default_rng(1).standard_normal(
        (B, tcfg.encoder_seq_len, tcfg.d_model), dtype=np.float32)


_REF = {}


def _reference(arch, changes, B, S, M, window):
    """The reference's stream of one input, shared by the cases that
    feed it: (logits [STEPS + 2, B, V], greedy tokens [B, STEPS + 1])."""
    key = (arch, changes, B, S, M, window)
    if key not in _REF:
        jcfg, np_params, tcfg = pair(arch, changes)
        _REF[key] = ref_stream(jcfg, np_params, tokens(tcfg, B, S), M, STEPS,
                               ext=tokens(tcfg, B, N_EXT, seed=1),
                               enc=_enc(tcfg, B), window=window)
    return _REF[key]


@pytest.mark.parametrize("case", CASES)
def test_extension_matches_reference(case):
    (arch, changes, shape, long_ctx, flash, B, S, M, window, impl,
     per_call) = CASES[case]
    _, np_params, tcfg = pair(arch, changes)
    toks, ext = tokens(tcfg, B, S), tokens(tcfg, B, N_EXT, seed=1)
    want, want_tok = _reference(arch, changes, B, S, M, window)

    def rank(mesh):
        if long_ctx:
            rules = dict(SH.long_context_rules(tcfg, mesh),
                         flash_decode=flash)
        else:
            rules = SH.rules_for(tcfg, mesh)
        rules["mesh"] = mesh
        seq = rules["cache_seq"]
        ext_colls = []
        got = port_stream(tcfg, np_params, toks, M, STEPS, rules, mesh,
                          ext=ext, enc=_enc(tcfg, B), impl=impl,
                          forced=want_tok, window=window,
                          ext_colls=ext_colls)
        return (rows(mesh, rules, B), got, ext_colls,
                mesh.axis_size(seq) if seq else 1)

    n_attn = (tcfg.num_layers // tcfg.hybrid_attn_every
              if tcfg.family == "hybrid" else tcfg.num_layers)
    V = tcfg.vocab_size
    for sl, (got, tok, colls), ext_colls, split in run_mesh(shape, rank):
        assert split == 2                      # the cache's sequence splits
        assert got.shape[0] == STEPS + 2       # prefill, decode, extension
        np.testing.assert_allclose(got[..., :V], want[:, sl, :V], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tok, want_tok[sl])
        assert colls == [per_call(n_attn)] * STEPS
        assert ext_colls == [per_call(n_attn)]


# ------------------------------------------------ the partials of S rows
B_, H_, KV_, D_, M_, S_ = 2, 4, 2, 16, 16, 4
R_LAT, RO = 24, 8


def _rows_inputs(mla):
    """S query rows at consecutive positions (12..15 and 7..10, the
    later rows' keys written ahead of them in the cache) over a cache
    whose key positions form a ring."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qp = np.array([[12, 13, 14, 15], [7, 8, 9, 10]], np.int32)
    kp = np.broadcast_to(np.arange(M_, dtype=np.int32), (B_, M_)).copy()
    kp[1, :3] = [16, 17, 18]                   # a ring: later keys first
    if mla:
        return (f(B_, S_, H_, R_LAT), f(B_, S_, H_, RO), f(B_, M_, R_LAT),
                f(B_, M_, RO)), qp, kp
    return (f(B_, S_, H_, D_) * 2.0, f(B_, M_, KV_, D_),
            f(B_, M_, KV_, D_)), qp, kp


@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
@pytest.mark.parametrize("window", [None, 6])
def test_rows_are_single_token_decodes(mla, window):
    """``flash_decode`` / ``flash_decode_mla`` over S = 4 rows on W = 2
    ranks: each row equals the S = 1 call of that row alone, and the
    whole equals the reference's plain attention over the whole cache
    (GQA: ``attention`` with per-row positions; MLA: the absorbed
    softmax); one pmax and two psums for the S rows together."""
    arrays, qp, kp = _rows_inputs(mla)
    if mla:
        ql, qr, c, kr = arrays
        s = (np.einsum("bshr,btr->bhst", ql, c)
             + np.einsum("bshk,btk->bhst", qr, kr)) / np.sqrt(40)
        mask = np.asarray(JL._attn_mask(qp, kp, None, window, True))
        s = np.where(mask[:, None], s, JL.NEG_INF)
        w = np.asarray(jax.nn.softmax(s, axis=-1))
        want = np.einsum("bhst,btr->bshr", w, c)
    else:
        q, k, v = arrays
        want = np.asarray(jax.jit(lambda: JL.attention(
            q, k, v, q_positions=qp, k_positions=kp, window=window))())

    def rank(mesh):
        r = mesh.axis_index("model")
        part = [torch.from_numpy(a[:, r * 8:(r + 1) * 8].copy())
                for a in arrays[2 if mla else 1:]]
        kps = torch.from_numpy(kp[:, r * 8:(r + 1) * 8].copy())
        qs = [torch.from_numpy(a) for a in arrays[:2 if mla else 1]]
        qpt = torch.from_numpy(qp)

        def call(sl):
            args = [t[:, sl] for t in qs]
            if mla:
                return DA.flash_decode_mla(*args, *part, qpt[:, sl], kps,
                                           mesh=mesh, window=window, qk_dim=40)
            return DA.flash_decode(*args, *part, qpt[:, sl], kps, mesh=mesh,
                                   window=window)

        before = dict(mesh.collectives)
        whole = call(slice(None))
        n = {k: v - before.get(k, 0) for k, v in mesh.collectives.items()}
        single = torch.cat([call(slice(s, s + 1)) for s in range(S_)], 1)
        return whole.numpy(), single.numpy(), n

    for whole, single, n in run_mesh((1, 2), rank):
        np.testing.assert_allclose(whole, single, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(whole, want, rtol=3e-5, atol=3e-5)
        assert n == {"all-reduce": 3}


def test_s1_decode_takes_the_partials_unchanged():
    """A single-token decode over a split cache routes as before: with
    ``flash_decode`` on a sequence axis of size 1 the S = 1 call still
    takes the partials (the reference's shard_map), an S > 1 call there
    attends plainly, as the reference does."""
    _, _, tcfg = pair("tinyllama-1.1b")
    cfg = dataclasses.replace(tcfg, num_layers=1)
    from repro_torch.models import layers as L
    from repro_torch.parallel.mesh import RankMesh

    mesh = RankMesh(("data", "model"), (1, 1), 0, "cpu")
    rules = dict(SH.long_context_rules(cfg, mesh), flash_decode=True,
                 mesh=mesh)
    g = torch.Generator().manual_seed(0)
    p = L.init_gqa(cfg, g, torch.float32)
    M = 8
    cache = {"k": torch.zeros(1, M, cfg.num_kv_heads, cfg.resolved_head_dim),
             "v": torch.zeros(1, M, cfg.num_kv_heads, cfg.resolved_head_dim)}
    kpos = torch.full((1, M), 2 ** 30, dtype=torch.int32)
    x = torch.randn((1, 3, cfg.d_model), generator=g)
    pos = torch.arange(3, dtype=torch.int32)[None]
    kpos[0, :3] = pos
    calls = []
    fn = DA.flash_decode

    def rec(*a, **k):
        calls.append(a[0].shape[1])
        return fn(*a, **k)

    DA.flash_decode = rec
    try:
        with SH.use_rules(rules):
            L.apply_gqa(p, x, cfg, positions=pos, cache=cache,
                        slots=pos.long(), k_positions=kpos)
            kpos[0, 3] = 3
            L.apply_gqa(p, x[:, :1], cfg, positions=pos[:, :1] + 3,
                        cache=cache, slots=pos[:, :1].long() + 3,
                        k_positions=kpos)
    finally:
        DA.flash_decode = fn
    assert calls == [1]
