"""Port parity, the audio family under sharding rules: whisper-medium's
encoder over a rank's rows of the frames, its decoder's self- and
cross-attention on split heads (the cross queries and the encoder output
entering them), the cross cache never sequence-split, every rank a
thread with its shard of the weights, cache and batch, against the
reference's UNSHARDED functions on the same weights (the reference's
``init_params``, bridged through numpy), ``.reduced()``:

* ``encode_audio`` on (1, 2) and (2, 2), 1e-4;
* serving under ``rules_for`` on (1, 2), (2, 1) and (2, 2): a prefill
  with frames, 2 decode steps fed the reference's greedy tokens and a
  3-token extension, logits 1e-4, greedy tokens equal, the collectives
  of each decode step as designed; the kernel routes' plain versions
  too; bf16 weights over fp32 frames against the unsharded port (2e-2
  relative L2 a call: the cross cache's leaves replaced at a rank's
  shard);
* serving under ``long_context_rules`` + ``flash_decode`` on (2, 1) and
  (2, 2): the self cache's slots split over ``data``, the cross cache
  whole, single-token decode steps by flash-decoding;
* the train step with batch-split frames (``sharded_batches(...,
  frames=True)``) on (1, 2), (2, 1) and (2, 2): the loss (1e-5), each
  gradient shard and each updated shard (1e-4 relative L2)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy, shard_from_numpy
from repro_torch.data import pipeline as TDP
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH
from _torch_mesh import rows, run_mesh
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_sharded import (frames, global_batch, pair, per_step_collectives,
                            port_stream, rank_train, ref_stream, ref_train,
                            rel, tokens, train_errors)

ARCH = "whisper-medium"
B, S, M, STEPS = 4, 10, 16, 2
DATA = TDP.DataConfig(seq_len=16, global_batch=4)
#: name -> (mesh, long context, kernel routes)
SERVE = {
    "1x2": ((1, 2), False, False),
    "2x1-kernel": ((2, 1), False, True),
    "2x2-kernel": ((2, 2), False, True),
    "long-2x1": ((2, 1), True, False),
    "long-2x2-kernel": ((2, 2), True, True),
}
MESHES = [(1, 2), (2, 1), (2, 2)]


@functools.cache
def _inputs():
    """(numpy weights, port cfg, prompt, extension, frames, the
    reference's logits and greedy tokens): one reference run."""
    jcfg, np_params, tcfg = pair(ARCH)
    toks = tokens(tcfg, B, S)
    ext = tokens(tcfg, B, 3, seed=1)
    enc = frames(tcfg, B)
    want, want_tok = ref_stream(jcfg, np_params, toks, M, STEPS, ext, enc)
    return np_params, tcfg, toks, ext, enc, want, want_tok


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_matches_reference(shape):
    jcfg, np_params, tcfg = pair(ARCH)
    enc = frames(tcfg, B)
    jp = jax.tree_util.tree_map(np.asarray, np_params)
    want = np.asarray(jax.jit(lambda p, f: JT.encode_audio(p, jcfg, f))(
        jp, enc))

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        p = shard_from_numpy(np_params, SH.param_specs(tcfg, np_params,
                                                       rules, mesh),
                             mesh, "cpu")
        sl = rows(mesh, rules, B)
        with SH.use_rules(rules):
            out = T.encode_audio(p, tcfg, torch.from_numpy(enc[sl]))
        return sl, out.numpy(), dict(mesh.collectives)

    L = tcfg.num_encoder_layers
    for sl, got, colls in run_mesh(shape, rank):
        np.testing.assert_allclose(got, want[sl], rtol=1e-4, atol=1e-4)
        assert colls == {"all-reduce": 2 * L}    # wo, w_down a layer


@pytest.mark.parametrize("case", SERVE)
def test_sharded_serving_matches_reference(case):
    shape, long_ctx, kernel = SERVE[case]
    np_params, tcfg, toks, ext, enc, want, want_tok = _inputs()
    calls = STEPS + 1 + (not long_ctx)

    def rank(mesh):
        if long_ctx:
            rules = dict(SH.long_context_rules(tcfg, mesh), flash_decode=True)
        else:
            rules = SH.rules_for(tcfg, mesh)
        rules["mesh"] = mesh
        c = T.init_cache_shard(tcfg, B, M, rules, mesh, "float32", "cpu")
        got = port_stream(tcfg, np_params, toks, M, STEPS, rules, mesh,
                          ext=None if long_ctx else ext, enc=enc,
                          impl="kernel" if kernel else "gather",
                          forced=want_tok)
        return (rows(mesh, rules, B), got,
                per_step_collectives(tcfg, mesh, long_ctx),
                tuple(c["layers"]["k"].shape), tuple(c["cross"]["k"].shape))

    V = tcfg.vocab_size
    for sl, (got, tok, colls), per_step, self_kv, cross_kv in run_mesh(
            shape, rank):
        np.testing.assert_allclose(got[..., :V], want[:calls, sl, :V],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tok, want_tok[sl])
        assert colls == [per_step] * STEPS
        d, m = shape
        b = B if long_ctx else B // d
        kvh = tcfg.num_kv_heads // m
        assert self_kv[1:4] == (b, M // d if long_ctx else M, kvh)
        assert cross_kv[1:4] == (b, tcfg.encoder_seq_len, kvh)


def test_bf16_weights_over_fp32_frames():
    """bf16 weights over fp32 frames (the engine's types): the prefill's
    cross K/V come out fp32, so ``_cross_cache`` replaces the bf16 cross
    leaves, at the rank's shard, as the unsharded forward does over the
    whole cache; on (2, 2) each rank's prefill and decode logits are
    within 2e-2 relative L2 of the unsharded port's on the same bf16
    weights (the reference's bf16 stream runs at full width in
    ``chip_smoke.py`` 13g)."""
    _, tcfg, toks, _, enc, _, want_tok = _inputs()
    np16 = pair(ARCH, (), "bfloat16")[1]
    full = params_from_numpy(np16, "cpu")
    cache = T.init_cache(tcfg, B, M, "bfloat16", "cpu")
    want = [T.forward(full, tcfg, torch.from_numpy(toks).long(), cache=cache,
                      mode="prefill", encoder_input=torch.from_numpy(enc))[0]]
    assert cache["cross"]["k"].dtype == torch.float32
    for t in range(STEPS):
        want.append(T.forward(full, tcfg, torch.tensor(
            want_tok[:, t:t + 1]).long(), positions=torch.full(
                (B, 1), S + t, dtype=torch.int32), cache=cache,
            mode="decode")[0])
    want = torch.stack(want).float().numpy()

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        return rows(mesh, rules, B), port_stream(
            tcfg, np16, toks, M, STEPS, rules, mesh, enc=enc,
            impl="kernel", forced=want_tok)[0]

    V = tcfg.vocab_size
    for sl, got in run_mesh((2, 2), rank):
        for g, w in zip(got[..., :V], want[:, sl, :V]):
            assert rel(g, w) <= 2e-2


@functools.cache
def _train_ref():
    jcfg, np_params, tcfg = pair(ARCH)
    return ref_train(jcfg, np_params, global_batch(tcfg, DATA))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_train_step_matches_reference(shape):
    _, np_params, tcfg = pair(ARCH)
    ref = _train_ref()

    def rank(mesh):
        rules = dict(SH.rules_for(tcfg, mesh), mesh=mesh)
        return train_errors(rank_train(tcfg, np_params, DATA, mesh, rules),
                            ref)

    for losses, grads, params in run_mesh(shape, rank):
        assert max(losses) <= 1e-5, losses
        worst = max(grads, key=grads.get)
        assert grads[worst] <= 1e-4, ("grad", worst, grads[worst])
        worst = max(params, key=params.get)
        assert params[worst] <= 1e-4, ("param", worst, params[worst])


def test_sharded_batches_carry_frames():
    """``sharded_batches(..., frames=True)``: each rank's rows of the
    tokens and of ``synth_frames``, split alike."""
    tcfg = pair(ARCH)[2]
    dcfg = TDP.DataConfig(seq_len=8, global_batch=4)

    def rank(mesh):
        return mesh.axes_index("data"), next(TDP.sharded_batches(
            tcfg, dcfg, mesh, ("data", None), 1, frames=True))

    whole = global_batch(tcfg, dcfg)
    for i, b in run_mesh((2, 1), rank):
        assert set(b) == {"tokens", "labels", "mask", "frames"}
        for k, v in b.items():
            np.testing.assert_array_equal(v.numpy(),
                                          whole[k][2 * i:2 * i + 2])
