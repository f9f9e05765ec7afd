"""Port parity, request migration: the paged pool's block export/import
(the migration wire format) against the reference's on the same pool
state, bf16 carried as raw bits; the engine's migration surface
(stop-the-world, two-phase, mid-prefill) token-identical to the
unmigrated JAX run, greedy and sampled; migration across frameworks in
both directions; and ``core.migration``'s cost model."""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import migration as JMIG
from repro.serving import paged_kv as JPK
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.core import migration as MIG
from repro_torch.core import replication as R
from repro_torch.serving import paged_kv as PK
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.instrument import count_host_syncs
from _torch_parity import jax_solo_streams, specs, tiny_pair
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import partitionable_threefry  # noqa: F401

pytestmark = pytest.mark.usefixtures("partitionable_threefry")


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


# ------------------------------------------------------------ pool helpers
def _pools(tiny, n_blocks, *, dtype="float32", prefix=False, batch=3):
    jcfg, _, tcfg, _ = tiny
    kw = dict(block_size=8, dtype=dtype, max_len=64, prefix_cache=prefix)
    return (JPK.init_paged(jcfg, batch, n_blocks, **kw),
            PK.init_paged(tcfg, batch, n_blocks, device="cpu", **kw))


def _kv(tiny, n, seed):
    cfg = tiny[2]
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cfg.num_layers, n, cfg.num_kv_heads,
                            cfg.resolved_head_dim)).astype(np.float32)


def _write(j, t, slot, kv):
    """The same append into both pools (v is 2k)."""
    n = kv.shape[1]
    JPK.allocate(j, slot, n)
    JPK.write_tokens(j, slot, jnp.asarray(kv), jnp.asarray(2 * kv))
    PK.allocate(t, slot, n)
    PK.write_tokens(t, slot, torch.from_numpy(kv), torch.from_numpy(2 * kv))


def _bits(a):
    """A pool array or payload array as raw bits (bf16 -> uint16)."""
    a = np.asarray(a.view(torch.int16) if isinstance(a, torch.Tensor)
                   and a.dtype == torch.bfloat16 else a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _book(st):
    """The host bookkeeping of a pool, comparable across packages."""
    return {"tables": st.block_tables.tolist(),
            "lengths": st.lengths.tolist(),
            "refcount": st.refcount.tolist(),
            "free": list(st.free), "cached_free": list(st.cached_free),
            "prefix_cache": dict(st.prefix_cache),
            "epoch": st.write_epoch,
            "block_epoch": st.block_epoch.tolist(),
            "dedup": st.dedup_imports, "saved": st.blocks_saved_total}


def _assert_same_pool(j, t):
    assert _book(j) == _book(t)
    # the real blocks: the port's pool also holds its scratch block
    n = t.n_blocks
    np.testing.assert_array_equal(_bits(np.asarray(j.k)), _bits(t.k[:, :n]))
    np.testing.assert_array_equal(_bits(np.asarray(j.v)), _bits(t.v[:, :n]))


def _assert_same_payload(jp, tp):
    for key in ("length", "block_size", "keys", "epoch", "nbytes"):
        assert jp[key] == tp[key], key
    np.testing.assert_array_equal(jp["cols"], tp["cols"])
    for a in ("k", "v"):
        np.testing.assert_array_equal(_bits(jp[a]), _bits(tp[a]))


# --------------------------------------------------- export / import (pool)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_matches_reference(tiny, dtype):
    """Full and delta exports of the same pool state: same columns, keys,
    epochs and byte counts as the reference, the same block bits (bf16
    as uint16, tagged), and exactly one counted device→host copy per
    array."""
    j, t = _pools(tiny, 16, dtype=dtype, prefix=True)
    toks = np.arange(2, 15, dtype=np.int32)
    _write(j, t, 0, _kv(tiny, 13, 0))
    JPK.register_prefix(j, 0, toks)
    PK.register_prefix(t, 0, toks)
    with count_host_syncs() as c:
        tp = PK.export_blocks(t, 0)
    assert c.n == 2
    _assert_same_payload(JPK.export_blocks(j, 0), tp)
    assert tp["keys"] and len(tp["cols"]) == 2
    assert tp.get("kv_dtype") == ("bfloat16" if dtype == "bfloat16" else None)
    assert tp["nbytes"] == 2 * tp["k"].size * (2 if dtype == "bfloat16"
                                               else 4)
    epoch = tp["epoch"]
    _write(j, t, 0, _kv(tiny, 4, 1))      # crosses into column 2
    jd = JPK.export_blocks(j, 0, since_epoch=epoch)
    td = PK.export_blocks(t, 0, since_epoch=epoch)
    _assert_same_payload(jd, td)
    assert td["cols"].tolist() == [1, 2]


def test_import_matches_reference_with_dedupe(tiny):
    """Import into a pool whose prefix cache already holds the payload's
    first block (parked on cached_free): both packages alias and revive
    it, allocate the rest fresh, re-seed the keys, and end with the same
    bookkeeping and the same pool bits."""
    toks = np.arange(2, 15, dtype=np.int32)
    kv = _kv(tiny, 13, 0)
    js, ts = _pools(tiny, 16, prefix=True)
    _write(js, ts, 0, kv)
    JPK.register_prefix(js, 0, toks)
    PK.register_prefix(ts, 0, toks)
    jd, td = _pools(tiny, 8, prefix=True)
    _write(jd, td, 2, kv[:, :8])           # the same first block, resident
    JPK.register_prefix(jd, 2, toks[:8])
    PK.register_prefix(td, 2, toks[:8])
    JPK.free_slot(jd, 2)
    PK.free_slot(td, 2)
    assert td.cached_free                  # revivable, refcount 0
    JPK.import_blocks(jd, 1, JPK.export_blocks(js, 0))
    with count_host_syncs() as c:
        PK.import_blocks(td, 1, PK.export_blocks(ts, 0))
    assert c.uploads == 4                  # export ids; import ids, k, v
    _assert_same_pool(jd, td)
    assert td.dedup_imports == 1 and td.refcount.max() == 1


@pytest.mark.parametrize("prefix", [False, True])
def test_import_refusal_matches_reference(tiny, prefix):
    """Pools of 1–4 blocks: each package refuses the same imports, and a
    refused import mutates nothing (the revive of a cached-free resident
    counts against the vacancy)."""
    toks = np.arange(2, 26, dtype=np.int32)
    kv = _kv(tiny, 24, 2)
    js, ts = _pools(tiny, 16, prefix=True)
    _write(js, ts, 0, kv)
    JPK.register_prefix(js, 0, toks)
    PK.register_prefix(ts, 0, toks)
    jpay, tpay = JPK.export_blocks(js, 0), PK.export_blocks(ts, 0)
    refused = 0
    for n in range(1, 5):
        jd, td = _pools(tiny, n, prefix=prefix)
        if n > 1:                          # one resident, cached-free
            _write(jd, td, 2, kv[:, :8])
            JPK.register_prefix(jd, 2, toks[:8])
            PK.register_prefix(td, 2, toks[:8])
            JPK.free_slot(jd, 2)
            PK.free_slot(td, 2)
        before = _book(td)
        try:
            JPK.import_blocks(jd, 0, jpay)
            j_ok = True
        except JPK.OutOfBlocks:
            j_ok = False
        try:
            PK.import_blocks(td, 0, tpay)
            t_ok = True
        except PK.OutOfBlocks:
            t_ok = False
            assert _book(td) == before
        assert j_ok == t_ok, n
        refused += not t_ok
        _assert_same_pool(jd, td)
    assert 0 < refused < 4


@pytest.mark.parametrize("shared_tail", [False, True])
def test_import_delta_matches_reference(tiny, shared_tail):
    """Commit half of two-phase migration over a staged base: owned
    staged columns are overwritten in place; a staged column another
    slot aliased meanwhile is rebound to a fresh block (its co-holder
    keeps the old content); new columns allocate. Same result as the
    reference."""
    js, ts = _pools(tiny, 16)
    _write(js, ts, 0, _kv(tiny, 13, 0))
    jsnap, tsnap = JPK.export_blocks(js, 0), PK.export_blocks(ts, 0)
    jd, td = _pools(tiny, 8)
    JPK.import_blocks(jd, 0, jsnap)
    PK.import_blocks(td, 0, tsnap)
    if shared_tail:                        # an admission aliased col 0-1
        blocks = [int(b) for b in td.block_tables[0, :2]]
        JPK.adopt_prefix(jd, 1, blocks, 16)
        PK.adopt_prefix(td, 1, blocks, 16)
    _write(js, ts, 0, _kv(tiny, 6, 3))     # decode past the snapshot
    JPK.import_blocks_delta(jd, 0, JPK.export_blocks(
        js, 0, since_epoch=jsnap["epoch"]))
    PK.import_blocks_delta(td, 0, PK.export_blocks(
        ts, 0, since_epoch=tsnap["epoch"]))
    _assert_same_pool(jd, td)
    assert int(td.lengths[0]) == 19
    gk, _ = PK.gather_request(td, 0, 19)
    sk, _ = PK.gather_request(ts, 0, 19)
    torch.testing.assert_close(gk, sk, rtol=0, atol=0)


# ------------------------------------------------------- across frameworks
def test_bf16_blocks_cross_framework(tiny):
    """bf16 on the wire: a reference payload (ml_dtypes arrays) lands in
    the port's bf16 pool bit for bit, and widens exactly into an fp32
    pool; the port's tagged uint16 bits, converted in the test, land in
    the reference's bf16 pool bit for bit."""
    kv = _kv(tiny, 13, 4)
    js, ts = _pools(tiny, 16, dtype="bfloat16")
    _write(js, ts, 0, kv)
    jpay, tpay = JPK.export_blocks(js, 0), PK.export_blocks(ts, 0)
    assert jpay["k"].dtype.name == "bfloat16"
    assert tpay["k"].dtype == np.uint16 and tpay["kv_dtype"] == "bfloat16"
    _, td = _pools(tiny, 8, dtype="bfloat16")
    PK.import_blocks(td, 1, jpay)
    ids = torch.from_numpy(td.block_tables[1, :2].astype(np.int64))
    np.testing.assert_array_equal(_bits(td.k[:, ids]), _bits(jpay["k"]))
    np.testing.assert_array_equal(_bits(td.v[:, ids]), _bits(jpay["v"]))
    _, tf = _pools(tiny, 8)
    PK.import_blocks(tf, 1, jpay)
    np.testing.assert_array_equal(
        tf.k[:, ids].numpy(), np.asarray(jpay["k"], np.float32))
    jd, _ = _pools(tiny, 8, dtype="bfloat16")
    conv = dict(tpay, k=tpay["k"].view(ml_dtypes.bfloat16),
                v=tpay["v"].view(ml_dtypes.bfloat16))
    JPK.import_blocks(jd, 1, conv)
    jids = jnp.asarray(jd.block_tables[1, :2])
    np.testing.assert_array_equal(_bits(np.asarray(jd.k[:, jids])),
                                  tpay["k"])


def test_bf16_float32_wire_reference_import(tiny):
    """The float32 wire (fault C4): a port bf16 pool exported as plain
    float32 arrays, untagged, at twice the bytes of the bits wire; the
    reference's ``import_blocks`` (which converts arrays by value) lands
    it bit-equal to the source pool, and so does the port's own import.
    A bf16 -> float32 -> bf16 round trip is exact."""
    kv = _kv(tiny, 13, 6)
    js, ts = _pools(tiny, 16, dtype="bfloat16")
    _write(js, ts, 0, kv)
    bits = PK.export_blocks(ts, 0)
    wide = PK.export_blocks(ts, 0, wire="float32")
    assert wide["k"].dtype == np.float32 and "kv_dtype" not in wide
    assert wide["nbytes"] == 2 * bits["nbytes"] == wide["k"].nbytes * 2
    ids = torch.from_numpy(ts.block_tables[0, :2].astype(np.int64))
    src_k, src_v = _bits(ts.k[:, ids]), _bits(ts.v[:, ids])
    jd, td = _pools(tiny, 8, dtype="bfloat16")
    JPK.import_blocks(jd, 1, wide)
    jids = jnp.asarray(jd.block_tables[1, :2])
    np.testing.assert_array_equal(_bits(np.asarray(jd.k[:, jids])), src_k)
    np.testing.assert_array_equal(_bits(np.asarray(jd.v[:, jids])), src_v)
    PK.import_blocks(td, 1, wide)
    tids = torch.from_numpy(td.block_tables[1, :2].astype(np.int64))
    np.testing.assert_array_equal(_bits(td.k[:, tids]), src_k)
    np.testing.assert_array_equal(_bits(td.v[:, tids]), src_v)
    with pytest.raises(ValueError, match="wire"):
        PK.export_blocks(ts, 0, wire="uint16")


def test_float32_wire_through_the_engine_and_migrate_blocks(tiny):
    """The wire choice reaches the callers that build payloads: a bf16
    port engine's pause and snapshot payloads on the float32 wire resume
    on another port engine token-identically to the bits wire, and
    ``core.migration.migrate_blocks`` counts the bytes it shipped."""
    _, _, tcfg, tp = tiny

    def bf16(tree):
        return ({k: bf16(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.to(torch.bfloat16))
    tp = bf16(tp)
    rows = [(0, _prompts()[0], 8, 0.8, 16, 3)]
    kw = dict(max_batch=1, max_len=64, block_size=8, dtype="bfloat16")
    out = {}
    for wire in ("bits", "float32"):
        a, b = (Engine(tcfg, tp, device="cpu", **kw) for _ in range(2))
        req = a.submit(specs(rows, jax_side=False)[0])
        for _ in range(2):
            a.step()
        snap = a.snapshot_request(req.slot, wire=wire)
        assert (snap["kv"]["k"].dtype == np.float32) == (wire == "float32")
        payload = a.pause_request(req.slot, wire=wire)
        assert b.resume_request(payload)
        out[wire] = b.run_until_done()[0].generated
    assert out["bits"] == out["float32"]
    src, dst = _pools(tiny, 8, dtype="bfloat16")[1], _pools(
        tiny, 8, dtype="bfloat16")[1]
    PK.allocate(src, 0, 13)
    PK.write_tokens(src, 0, torch.from_numpy(_kv(tiny, 13, 7)),
                    torch.from_numpy(_kv(tiny, 13, 8)))
    payload, cost = MIG.migrate_blocks(src, dst, 0, 0, wire="float32")
    assert cost.bytes_moved == payload["nbytes"] == 2 * 2 * 2 * (
        tcfg.num_layers * tcfg.num_kv_heads * 8 * tcfg.resolved_head_dim * 2)


def _cross_payload(payload, req_cls):
    """A pause payload of one package for the other: the Request through
    ``dataclasses.asdict`` (the fields are identical), the rest as is."""
    return dict(payload,
                request=req_cls(**dataclasses.asdict(payload["request"])))


SAMPLINGS = [(0.0, 0), (0.8, 16)]


@pytest.mark.parametrize("temperature,top_k", SAMPLINGS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_framework_migration(tiny, direction, temperature, top_k):
    """Pause mid-decode in one package's engine, resume in the other's:
    the continuation is token-identical to the unmigrated reference run
    (fp32), greedy and sampled."""
    jcfg, jp, tcfg, tp = tiny
    rows = [(0, np.arange(3, 14, dtype=np.int32), 10, temperature, top_k,
             11)]
    ref = jax_solo_streams(jcfg, jp, rows)
    kw = dict(max_batch=1, max_len=64, block_size=8)
    jeng = JaxEngine(jcfg, jp, cache_kind="paged", **kw)
    teng = Engine(tcfg, tp, device="cpu", **kw)
    if direction == "jax_to_port":
        src, dst, req_cls = jeng, teng, Request
        src.submit(specs(rows, jax_side=True)[0])
    else:
        src, dst, req_cls = teng, jeng, JaxRequest
        src.submit(specs(rows, jax_side=False)[0])
    for _ in range(3):
        src.step()
    payload = src.pause_request(0)
    assert len(payload["request"].generated) == 4   # admission token + 3
    assert dst.resume_request(_cross_payload(payload, req_cls))
    done = dst.run_until_done()
    assert done[0].generated == ref[0]
    assert src.pstate.blocks_in_use() == 0


# ----------------------------------------------------- engine surface
def _prompts():
    return [np.arange(2 + i, 12 + i, dtype=np.int32) for i in range(2)]


@pytest.mark.parametrize("temperature,top_k", SAMPLINGS)
def test_engine_pause_resume_token_identical(tiny, temperature, top_k):
    """Stop-the-world between two port engines: both decoding requests
    leave A with their blocks, A's pool is empty, and B finishes both
    streams token-identically to the unmigrated reference."""
    jcfg, jp, tcfg, tp = tiny
    rows = [(i, p, 10, temperature, top_k, 7 + i)
            for i, p in enumerate(_prompts())]
    ref = jax_solo_streams(jcfg, jp, rows)
    a, b = (Engine(tcfg, tp, device="cpu", max_batch=2, max_len=64,
                   block_size=8) for _ in range(2))
    for s in specs(rows, jax_side=False):
        a.submit(s)
    for _ in range(3):
        a.step()
    for slot in sorted(a.slot_rids()):
        payload = a.pause_request(slot)
        assert payload["v"] == 2 and payload["phase"] == "decode"
        with count_host_syncs() as c:
            assert b.resume_request(payload)
        assert c.n == 0                  # an import never waits
    assert a.pstate.blocks_in_use() == 0 and not a.active
    done = {r.rid: r.generated for r in b.run_until_done()}
    assert done == ref


@pytest.mark.parametrize("temperature,top_k", SAMPLINGS)
def test_engine_two_phase_token_identical(tiny, temperature, top_k):
    """Two-phase: snapshot, stage at B (the staged slot is closed to
    admission), A keeps decoding, then pause with the dirty-set delta
    and commit. Token-identical to the unmigrated reference."""
    jcfg, jp, tcfg, tp = tiny
    rows = [(0, _prompts()[0], 12, temperature, top_k, 5)]
    ref = jax_solo_streams(jcfg, jp, rows)
    a, b = (Engine(tcfg, tp, device="cpu", max_batch=2, max_len=64,
                   block_size=8) for _ in range(2))
    req = a.submit(specs(rows, jax_side=False)[0])
    for _ in range(2):
        a.step()
    snap = a.snapshot_request(req.slot)
    staged = b.prepare_resume(snap)
    assert staged is not None and staged not in b._free_slots()
    n0 = len(req.generated)
    for _ in range(3):
        a.step()
    assert len(req.generated) == n0 + 3
    delta = a.pause_request(req.slot, since_epoch=snap["epoch"])
    assert len(snap["kv"]["cols"]) == 2
    assert delta["kv"]["cols"].tolist() == [1]   # the tail block only
    assert delta["kv"]["nbytes"] < snap["kv"]["nbytes"]
    assert b.commit_resume(staged, delta)
    assert not b._staged and a.pstate.blocks_in_use() == 0
    assert b.run_until_done()[0].generated == ref[0]


def test_engine_mid_prefill_migration(tiny):
    """A request paused MID-PREFILL (chunked under a small token budget)
    carries its cursor and written blocks; the destination finishes the
    prompt without replay and the stream matches the reference."""
    jcfg, jp, tcfg, tp = tiny
    prompt = np.random.default_rng(9).integers(2, 256, 40).astype(np.int32)
    rows = [(0, prompt, 6, 0.0, 0, 0)]
    ref = jax_solo_streams(jcfg, jp, rows)
    a, b = (Engine(tcfg, tp, device="cpu", max_batch=1, max_len=64,
                   block_size=8, token_budget=16) for _ in range(2))
    req = a.submit(specs(rows, jax_side=False)[0])
    a.step()
    assert req.slot in a.prefilling and req.prefill_pos == 16
    payload = a.pause_request(req.slot)
    assert payload["phase"] == "prefill" and payload["kv"]["length"] == 16
    assert b.resume_request(payload)
    assert b.prefilling and req.prefill_pos == 16
    assert b.run_until_done()[0].generated == ref[0]


def test_engine_resume_refusals(tiny):
    """No free block: resume returns False and leaves the pool as it
    was; an alien wire version raises before any bind."""
    _, _, tcfg, tp = tiny
    a = Engine(tcfg, tp, device="cpu", max_batch=1, max_len=64,
               block_size=8)
    b = Engine(tcfg, tp, device="cpu", max_batch=1, max_len=64,
               block_size=8, n_blocks=1)
    a.submit(specs([(0, _prompts()[0], 8, 0.0, 0, 0)], jax_side=False)[0])
    a.step()
    payload = a.pause_request(0)
    before = _book(b.pstate)
    assert not b.resume_request(payload)
    assert _book(b.pstate) == before and not b.active
    for op in ("resume_request", "prepare_resume"):
        with pytest.raises(ValueError, match="version"):
            getattr(b, op)(dict(payload, v=1))


# ------------------------------------------------------- core/migration
def test_migrate_blocks_matches_reference(tiny):
    """migrate_blocks moves the reference's bytes, prices them with the
    same Table-2 model, leaves the same destination pool and frees the
    source."""
    js, ts = _pools(tiny, 16)
    jd, td = _pools(tiny, 16)
    _write(js, ts, 0, _kv(tiny, 21, 5))
    jpay, jcost = JMIG.migrate_blocks(js, jd, 0, 1)
    tpay, tcost = MIG.migrate_blocks(ts, td, 0, 1, measure=True)
    assert (tcost.bytes_moved, tcost.est_seconds) == (jcost.bytes_moved,
                                                      jcost.est_seconds)
    assert tcost.measured_seconds > 0
    _assert_same_pool(jd, td)
    _assert_same_pool(js, ts)
    assert ts.blocks_in_use() == 0


def test_cost_model_and_tree_bytes_match_reference(tiny):
    """tree_bytes over the port's nested dict of tensors equals the
    reference's over its pytree; estimate_cost is the same function."""
    _, jp, _, tp = tiny
    for rx in (".*", "layers/", "^embed", "attn"):
        assert MIG.tree_bytes(tp, rx) == JMIG.tree_bytes(jp, rx), rx
    for b in (0, 4096, 10**9):
        assert MIG.estimate_cost(b, 50e9) == JMIG.estimate_cost(b, 50e9)


def test_fit_migration_model_on_cpu(tiny):
    """The probe moves exactly one request's K and V, and the fit
    returns the reference's fields; off the card it needs device='cpu'."""
    cfg = tiny[2]
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    fit = MIG.fit_migration_model(cfg, block_size=8, small_tokens=16,
                                  large_tokens=64, repeats=1,
                                  device="cpu")
    assert fit["probe_large"]["bytes"] == 2 * L * 64 * KV * hd * 4
    assert fit["probe_small"]["bytes"] == 2 * L * 16 * KV * hd * 4
    assert fit["fixed_overhead_s"] > 0 and fit["bandwidth_Bps"] > 0
    _, nb = MIG.probe_block_migration(cfg, 16, block_size=8, repeats=1,
                                      dtype="bfloat16", device="cpu")
    assert nb == 2 * L * 16 * KV * hd * 2


def test_resharding_and_default_device(tiny, monkeypatch):
    """Re-placing over the size-1 group keeps every tensor where it is
    and counts its bytes (a group of several ranks:
    tests/test_torch_replication.py); probing without a device and
    without CUDA refuses rather than running on the CPU."""
    solo = R.default_replication_group("cpu")
    t = torch.arange(12.0).view(3, 4)
    new, cost = MIG.migrate_by_path({"a": [t], "b": t}, r"^a/", (None, "r0"),
                                    solo)
    assert new["a"][0].data_ptr() == t.data_ptr() and new["b"] is t
    assert cost.bytes_moved == 48
    cache = {"layers": {"k": t}, "positions": t}
    assert MIG.migrate_kv_cache(cache, (), solo)[1].bytes_moved == 48
    st = _pools(tiny, 8)[1]
    k = st.k
    _, cost = MIG.migrate_paged_pool(st, (), solo)
    assert st.k is k and cost.bytes_moved == 2 * k.numel() * k.element_size()
    with pytest.raises(ValueError, match="axis"):
        MIG.migrate_by_path({"a": t}, ".*", ("r1",), solo)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MIG.probe_block_migration(tiny[2], 8, repeats=1)
