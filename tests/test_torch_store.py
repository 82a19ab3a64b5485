"""The port's store against the JAX package's: the raw-signature path,
band modes, index-only stores, digests and snapshots that cross-load both
ways, for the single store and the sharded plane.

Every case feeds the same seeded numpy signatures to both packages (CPU on
the port's side) and asserts the answers are identical: ids, scores
(count.float32 / k on both sides: tolerance 0), candidate pairs, digests,
table geometry and, after a load, the table's records, counts and spill.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.lsh import band_hashes, candidate_pairs
from repro.kernels import ops as ref_ops
from repro.serve.search import SearchConfig as RefSearchConfig
from repro.serve.search import SimilaritySearchService as RefService
from repro.store import InProcessShard as RefInProcessShard
from repro.store import PackedConfig as RefPackedConfig
from repro.store import PackedSignatureBuffer as RefBuffer
from repro.store import ShardedSketchStore as RefSharded
from repro.store import SketchStore as RefStore
from repro.store import StoreConfig as RefStoreConfig
from repro_torch import convert
from repro_torch.serve.search import SearchConfig, SimilaritySearchService
from repro_torch.store import (InProcessShard, PackedConfig,
                               PackedSignatureBuffer, ShardedSketchStore,
                               SketchStore, StoreConfig)
from repro_torch.store.packed import pack_host
from repro_torch.store.sharded import MANIFEST_FILE, shard_snapshot_path

K, NB, R = 64, 16, 4
SHARD_COUNTS = [1, 2, 3, 8]


def _pair(**cfg):
    """A reference store and a port store on the CPU with one config."""
    return (RefStore(RefStoreConfig(k=K, n_bands=NB, rows_per_band=R, **cfg)),
            SketchStore(StoreConfig(k=K, n_bands=NB, rows_per_band=R, **cfg),
                        device="cpu"))


def _sharded_pair(s, **kw):
    cfg = kw.pop("cfg", {})
    return (RefSharded(RefStoreConfig(k=K, n_bands=NB, rows_per_band=R,
                                      **cfg), s, **kw),
            ShardedSketchStore(StoreConfig(k=K, n_bands=NB, rows_per_band=R,
                                           **cfg), s, device="cpu", **kw))


def _same(want, got, what=""):
    assert got[0].dtype == np.int64 and got[1].dtype == np.float32
    assert np.array_equal(got[0], want[0]), what
    assert np.array_equal(got[1], want[1]), what


def _corpus_sigs(n=200, k=K, vals=1 << 16, seed=6):
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, vals, (n, k), dtype=np.int32)
    sigs[n // 2] = sigs[7]      # planted exact dup
    return sigs


def _strangers(n, seed=8):
    rng = np.random.default_rng(seed)
    return rng.integers(1 << 20, 1 << 24, (n, K), dtype=np.int32)


def _queries(sigs, n_strangers=2, seed=1):
    """Indexed rows plus strangers that hit no bucket (the fallback)."""
    return np.concatenate([sigs[:12], _strangers(n_strangers, seed)])


def _table_state(t):
    return (t.records, t.counts, t._spill_band, t._spill_key, t._spill_id,
            t.hash_log)


def _assert_tables_equal(a, b):
    assert (a.n_slots, a.bucket_width, a.max_probes, a.n_items) == \
        (b.n_slots, b.bucket_width, b.max_probes, b.n_items)
    for x, y in zip(_table_state(a), _table_state(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _npz_layout(path):
    with np.load(path) as z:
        return {k: (z[k].dtype, z[k].shape) for k in z.files}


# -- the packed buffer -------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 8, 32])
def test_buffer_append_codes_and_nbytes_match_reference(b):
    rng = np.random.default_rng(b)
    sigs = rng.integers(0, 1 << 16, (100, 40), dtype=np.int32)
    ref = RefBuffer(RefPackedConfig(k=40, b=b, capacity=8))
    port = PackedSignatureBuffer(PackedConfig(k=40, b=b, capacity=8), "cpu")
    for lo in range(0, 100, 13):
        assert np.array_equal(port.append(sigs[lo: lo + 13]),
                              ref.append(sigs[lo: lo + 13]))
    assert port.nbytes == ref.nbytes and port.size == ref.size == 100
    assert np.array_equal(port.all_packed(), ref.all_packed())
    ids = np.asarray([0, 57, 99])
    assert np.array_equal(port.codes(ids).numpy(),
                          np.asarray(ref.codes(ids)))


def test_buffer_snapshots_cross_load(tmp_path):
    rng = np.random.default_rng(1)
    sigs = rng.integers(0, 1 << 12, (23, 17), dtype=np.int32)
    ref = RefBuffer(RefPackedConfig(k=17, b=4, capacity=8))
    port = PackedSignatureBuffer(PackedConfig(k=17, b=4, capacity=8), "cpu")
    ref.append(sigs)
    port.append(sigs)
    ref.save(str(tmp_path / "ref.npz"))
    port.save(str(tmp_path / "port.npz"))
    assert _npz_layout(tmp_path / "ref.npz") == \
        _npz_layout(tmp_path / "port.npz")
    a = PackedSignatureBuffer.load(str(tmp_path / "ref.npz"), device="cpu")
    c = RefBuffer.load(str(tmp_path / "port.npz"))
    assert (a.size, a.cfg.k, a.cfg.b) == (23, 17, 4)
    assert np.array_equal(a.codes(np.arange(23)).numpy(), sigs & 0xF)
    assert np.array_equal(np.asarray(c.codes(np.arange(23))), sigs & 0xF)


# -- the raw-signature store -------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 4, 32])
def test_raw_store_answers_like_the_reference(b):
    """Incremental raw adds through rebuilds and spills, then indexed rows
    and strangers (the fallback): ids, scores, digest, pairs, geometry and
    the hash log are the reference's."""
    sigs = _corpus_sigs(n=230)
    ref, port = _pair(b=b, n_slots=32, bucket_width=2)
    for lo in range(0, len(sigs), 61):
        assert np.array_equal(port.add(sigs[lo: lo + 61]),
                              ref.add(sigs[lo: lo + 61]))
    assert port.n_rebuilds == ref.n_rebuilds > 0
    _assert_tables_equal(ref.table, port.table)
    q = _queries(sigs, n_strangers=3)
    _same(ref.query(q, top_k=5), port.query(q, top_k=5), b)
    assert np.array_equal(port.candidate_rows(q), ref.candidate_rows(q))
    assert port.digest() == ref.digest()
    assert np.array_equal(port.candidate_pairs(), ref.candidate_pairs())
    assert port.buffer.nbytes == ref.buffer.nbytes


@pytest.mark.parametrize("b", [32, 2])
@pytest.mark.parametrize("packed", [False, True])
def test_store_queries_take_the_shard_leg_once_a_batch(monkeypatch, b,
                                                       packed):
    """``query`` (raw signatures) and ``query_packed`` (words, 16 rows a
    band so that b = 2 bands word-aligned) each reach
    ``partial_topk_packed_hashed``, the leg every shard runs, once a
    batch, over a table with spilled keys, and answer as the reference's
    store, the fallback rows included."""
    nb, r = (4, 16) if packed else (NB, R)
    cfg = dict(k=K, n_bands=nb, rows_per_band=r, b=b, n_slots=64,
               bucket_width=1, auto_rebuild=False)
    ref = RefStore(RefStoreConfig(**cfg))
    port = SketchStore(StoreConfig(**cfg), device="cpu")
    sigs = _corpus_sigs(n=120)
    sigs[60:90] = sigs[:30]                    # shared buckets: spills
    prep = (lambda x: pack_host(x, b)) if packed else (lambda x: x)
    add, query = ("add_packed", "query_packed") if packed else \
        ("add", "query")
    for store in (ref, port):
        getattr(store, add)(prep(sigs))
    assert port.n_spilled == ref.n_spilled > 0
    legs = []
    leg = port.partial_topk_packed_hashed

    def spy(*a, **kw):
        legs.append(kw["mode"])
        return leg(*a, **kw)
    monkeypatch.setattr(port, "partial_topk_packed_hashed", spy)
    for q in (_queries(sigs, n_strangers=3), sigs[[5, 61]]):
        _same(getattr(ref, query)(prep(q), top_k=5),
              getattr(port, query)(prep(q), top_k=5), (b, packed))
    assert legs == ["packed" if packed else "sig"] * 2


@pytest.mark.parametrize("top_k", [5, 10, 40])
def test_tied_brute_force_ranks_like_the_reference(top_k):
    """The brute-force partial and the masked candidate partial over a
    store whose scores mostly tie (K = 64 codes drawn from 4 values): ids
    and scores are the reference's, ties broken by the smaller id, at
    top_k below and above the select kernel's 32 keys a pass."""
    rng = np.random.default_rng(3)
    sigs = rng.integers(0, 4, (400, K)).astype(np.int32)
    q = rng.integers(0, 4, (37, K)).astype(np.int32)
    q[5] = sigs[17]                                     # an exact match
    ref, port = _pair(n_slots=256)
    ref.add(sigs)
    port.add(sigs)
    words = pack_host(q, 32)
    cand = rng.integers(-1, len(sigs), (len(q), 60))
    cand[4] = -1                                        # no candidate
    for want, got in (
            (ref.planner.brute_partial_packed(words, top_k),
             port.planner.brute_partial_packed(words, top_k)),
            (ref.planner.partial_topk_packed(words, cand, top_k),
             port.planner.partial_topk_packed(words, cand, top_k))):
        _same((want.ids, want.scores), (got.ids, got.scores), top_k)
        assert np.array_equal(got.has_candidates, want.has_candidates)


def _case_pregrow():
    return dict(cfg=dict(n_slots=32, bucket_width=4),
                batches=[_corpus_sigs(n=2000)], top_k=3)


def _case_bbit():
    return dict(cfg=dict(b=8), batches=[_corpus_sigs()], top_k=2,
                queries=_corpus_sigs()[[7, 3]])


def _case_duplicate_cluster():
    rng = np.random.default_rng(14)
    sigs = np.broadcast_to(rng.integers(0, 1 << 16, (1, K), np.int32),
                           (300, K)).copy()     # wider than the width cap
    return dict(cfg=dict(n_slots=256, bucket_width=4), batches=[sigs],
                top_k=5)


def _case_spill_cap_per_group():
    rng = np.random.default_rng(21)
    a = rng.integers(0, 1 << 16, K, dtype=np.int32)
    b = rng.integers(0, 1 << 16, K, dtype=np.int32)
    b[:R] = a[:R]                       # clusters share band 0 only
    sigs = np.concatenate([np.tile(a, (6, 1)), np.tile(b, (6, 1))])
    return dict(cfg=dict(bucket_width=1, auto_rebuild=False),
                batches=[sigs], top_k=3, queries=sigs[[6, 0]])


def _case_hot_spill():
    rng = np.random.default_rng(19)
    sigs = np.broadcast_to(rng.integers(0, 1 << 16, (1, K), np.int32),
                           (50, K)).copy()
    return dict(cfg=dict(bucket_width=2, auto_rebuild=False),
                batches=[sigs], top_k=5, queries=sigs[[0]])


def _case_spilled_join_only_matching():
    rng = np.random.default_rng(15)
    sigs = rng.integers(0, 1 << 16, (8, K), dtype=np.int32)
    sigs[1] = sigs[0]                   # width-1 bucket -> doc 1 spills
    return dict(cfg=dict(bucket_width=1, auto_rebuild=False),
                batches=[sigs], top_k=8, queries=sigs[[3, 0]])


def _case_fallback_with_spill():
    rng = np.random.default_rng(13)
    sigs = np.broadcast_to(rng.integers(0, 1 << 16, (1, K), np.int32),
                           (6, K)).copy()
    sigs[4] = rng.integers(0, 1 << 16, K, dtype=np.int32)
    sigs[5] = rng.integers(0, 1 << 16, K, dtype=np.int32)
    return dict(cfg=dict(bucket_width=1, auto_rebuild=False),
                batches=[sigs], top_k=6, queries=_strangers(1, seed=13))


def _case_empty_then_fallback():
    return dict(cfg={}, batches=[], top_k=3,
                queries=np.zeros((2, K), np.int32))


STORE_CASES = {
    "pregrow": _case_pregrow, "bbit": _case_bbit,
    "duplicate_cluster": _case_duplicate_cluster,
    "spill_cap_per_group": _case_spill_cap_per_group,
    "hot_spill": _case_hot_spill,
    "spilled_join_only_matching": _case_spilled_join_only_matching,
    "fallback_with_spill": _case_fallback_with_spill,
    "empty_then_fallback": _case_empty_then_fallback,
}


@pytest.mark.parametrize("name", sorted(STORE_CASES))
def test_store_cases_match_reference(name):
    """``tests/test_store.py``'s raw store cases, run through both
    packages: every answer, the pairs, the spill and the geometry agree."""
    case = STORE_CASES[name]()
    ref, port = _pair(**case["cfg"])
    for batch in case["batches"]:
        assert np.array_equal(port.add(batch), ref.add(batch))
    _assert_tables_equal(ref.table, port.table)
    assert port.n_spilled == ref.n_spilled
    q = case.get("queries")
    if q is None:
        q = np.concatenate([case["batches"][0][:8], _strangers(2)])
    _same(ref.query(q, top_k=case["top_k"]),
          port.query(q, top_k=case["top_k"]), name)
    assert np.array_equal(port.candidate_pairs(), ref.candidate_pairs())
    if case["batches"]:
        hashes = band_hashes(np.concatenate(case["batches"]), NB, R)
        assert set(map(tuple, port.candidate_pairs())) == \
            candidate_pairs(hashes)
    assert port.digest() == ref.digest()


@pytest.mark.parametrize("b", [8, 16])
def test_mixing_band_modes_raises_like_the_reference(b):
    sigs = _corpus_sigs(n=40)
    words = np.asarray(ref_ops.pack_codes(jnp.asarray(sigs), b))
    for first, second in (("add", "add_packed"), ("add_packed", "add")):
        ref, port = _pair(b=b)
        data = {"add": sigs, "add_packed": words}
        getattr(ref, first)(data[first])
        getattr(port, first)(data[first])
        for store in (ref, port):
            with pytest.raises(ValueError, match="band keys"):
                getattr(store, second)(data[second])
        query = {"add": "query_packed", "add_packed": "query"}[first]
        for store in (ref, port):
            with pytest.raises(ValueError, match="band keys"):
                getattr(store, query)(data[second][:3], top_k=2)
    # b = 32: sig and packed keys are the same, so mixing is fine
    ref, port = _pair()
    w32 = np.asarray(ref_ops.pack_codes(jnp.asarray(sigs), 32))
    for store in (ref, port):
        store.add(sigs[:20])
        store.add_packed(w32[20:])
    _same(ref.query(sigs[:5], top_k=3), port.query(sigs[:5], top_k=3))
    _same(ref.query_packed(w32[:5], top_k=3),
          port.query_packed(w32[:5], top_k=3))


def test_packed_entry_points_refuse_misaligned_bands():
    """b = 2 at 4 rows a band: raw signatures band, packed words cannot."""
    sigs = _corpus_sigs(n=30)
    ref, port = _pair(b=2)
    words = np.zeros((3, port.buffer.cfg.n_words), np.uint32)
    for store in (ref, port):
        store.add(sigs)
        for call in (lambda: store.add_packed(words),
                     lambda: store.candidate_rows_packed(words)):
            with pytest.raises(ValueError, match="raw signatures"):
                call()
    _same(ref.query(sigs[:6], top_k=3), port.query(sigs[:6], top_k=3))


def test_index_only_store_matches_reference(tmp_path):
    sigs = _corpus_sigs(n=150)
    ref, port = _pair(store_signatures=False, b=2)
    for lo in range(0, 150, 50):
        assert np.array_equal(port.add(sigs[lo: lo + 50]),
                              ref.add(sigs[lo: lo + 50]))
    assert port.size == ref.size == 150 and port.buffer.size == 0
    for call in (lambda: port.query(sigs[:2]),
                 lambda: port.query_packed(np.zeros((2, 4), np.uint32))):
        with pytest.raises(RuntimeError, match="store_signatures"):
            call()
    assert np.array_equal(port.candidate_pairs(), ref.candidate_pairs())
    assert np.array_equal(port.candidate_rows(sigs[:9]),
                          ref.candidate_rows(sigs[:9]))
    assert port.digest() == ref.digest()
    port.save(str(tmp_path / "p.npz"))
    back = RefStore.load(str(tmp_path / "p.npz"))
    assert not back.cfg.store_signatures and back.size == 150
    assert np.array_equal(back.candidate_pairs(), ref.candidate_pairs())


# -- snapshots ---------------------------------------------------------------

def _snap_default():
    return dict(cfg=dict(b=16), sigs=_corpus_sigs())


def _snap_spilled():
    sigs = _corpus_sigs(n=60, vals=40)
    sigs[40:] = sigs[0]
    return dict(cfg=dict(bucket_width=1, auto_rebuild=False), sigs=sigs)


def _snap_raw_b2():
    return dict(cfg=dict(b=2, n_slots=32, bucket_width=2),
                sigs=_corpus_sigs(n=180))


def _snap_packed_b8():
    return dict(cfg=dict(b=8, rebuild_load_factor=0.55,
                         rebuild_spill_fraction=0.2),
                sigs=_corpus_sigs(), packed=True)


SNAPSHOTS = {"default": _snap_default, "spilled": _snap_spilled,
             "raw_b2": _snap_raw_b2, "packed_b8": _snap_packed_b8,
             "ten_int_cfg": _snap_default}


def _build(store, case):
    sigs = case["sigs"]
    if case.get("packed"):
        b = store.cfg.b
        store.add_packed(np.asarray(ref_ops.pack_codes(jnp.asarray(sigs),
                                                       b)))
    else:
        store.add(sigs)


def _query(store, case, top_k=4):
    q = np.concatenate([case["sigs"][:10], _strangers(2)])
    if case.get("packed"):
        return store.query_packed(np.asarray(
            ref_ops.pack_codes(jnp.asarray(q), store.cfg.b)), top_k=top_k)
    return store.query(q, top_k=top_k)


def _drop_band_mode(path):
    """Rewrite a snapshot with the 10-int cfg of earlier snapshots."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["cfg"] = arrays["cfg"][:10]
    np.savez(path, **arrays)


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_store_snapshots_cross_load_both_ways(name, tmp_path):
    case = SNAPSHOTS[name]()
    ref, port = _pair(**case["cfg"])
    _build(ref, case)
    _build(port, case)
    if name == "spilled":
        assert port.n_spilled > 0
    rpath, ppath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref.save(rpath)
    port.save(ppath)
    assert _npz_layout(rpath) == _npz_layout(ppath)
    if name == "ten_int_cfg":
        _drop_band_mode(rpath)
        _drop_band_mode(ppath)
    # the reference's snapshot, loaded by the port
    ref_back = RefStore.load(rpath)
    port_back = SketchStore.load(rpath, device="cpu")
    assert port_back._band_mode == ref_back._band_mode
    assert port_back.cfg == StoreConfig(**vars(ref_back.cfg))
    _assert_tables_equal(ref_back.table, port_back.table)
    assert port_back.digest() == ref_back.digest() == ref.digest()
    _same(_query(ref, case), _query(port_back, case), name)
    assert np.array_equal(port_back.candidate_pairs(),
                          ref_back.candidate_pairs())
    # the port's snapshot, loaded by the reference
    again = RefStore.load(ppath)
    assert again.digest() == port.digest() == ref.digest()
    _same(_query(again, case), _query(port, case), name)


# -- the sharded plane -------------------------------------------------------

@pytest.mark.parametrize("s", SHARD_COUNTS)
@pytest.mark.parametrize("partition", ["round_robin", "hash"])
def test_sharded_raw_query_matches_reference(s, partition):
    sigs = _corpus_sigs(n=160, seed=0)
    sigs[-3:] = sigs[:3]
    ref, port = _sharded_pair(s, partition=partition)
    assert np.array_equal(port.add(sigs), ref.add(sigs))
    assert np.array_equal(port.shard_sizes(), ref.shard_sizes())
    q = _queries(sigs)
    _same(ref.query(q, top_k=5), port.query(q, top_k=5), (s, partition))
    single = RefStore(RefStoreConfig(k=K, n_bands=NB, rows_per_band=R))
    single.add(sigs)
    _same(single.query(q, top_k=5), port.query(q, top_k=5))


@pytest.mark.parametrize("s", SHARD_COUNTS)
def test_sharded_packed_query_matches_reference(s):
    sigs = _corpus_sigs(n=160, seed=3)
    words = np.asarray(ref_ops.pack_codes(jnp.asarray(sigs), 32))
    qw = np.asarray(ref_ops.pack_codes(jnp.asarray(_queries(sigs, seed=4)),
                                       32))
    ref, port = _sharded_pair(s)
    ref.add_packed(words)
    port.add_packed(words)
    _same(ref.query_packed(qw, top_k=6), port.query_packed(qw, top_k=6), s)


@pytest.mark.parametrize("b,s", [(2, 3), (1, 2), (8, 8)])
def test_sharded_bbit_raw_store(b, s):
    sigs = _corpus_sigs(n=160, seed=5)
    ref, port = _sharded_pair(s, cfg=dict(b=b))
    ref.add(sigs)
    port.add(sigs)
    got = port.query(sigs[:8], top_k=3)
    _same(ref.query(sigs[:8], top_k=3), got, (b, s))
    assert (got[0][:, 0] == np.arange(8)).all()       # self-hit on top


def test_sharded_incremental_adds_interleave():
    sigs = _corpus_sigs(n=230, seed=6)
    ref, port = _sharded_pair(3, cfg=dict(n_slots=64, bucket_width=2))
    for lo in range(0, len(sigs), 37):
        assert np.array_equal(port.add(sigs[lo: lo + 37]),
                              ref.add(sigs[lo: lo + 37]))
    q = _queries(sigs, seed=7)
    _same(ref.query(q, top_k=4), port.query(q, top_k=4))


def test_sharded_empty_shards_and_tiny_corpus():
    sigs = np.random.default_rng(8).integers(0, 1 << 16, (3, K),
                                             dtype=np.int32)
    ref, port = _sharded_pair(8)
    ref.add(sigs)
    port.add(sigs)
    assert int(port.shard_sizes().sum()) == 3
    q = np.concatenate([sigs[:2], _strangers(1, seed=9)])
    _same(ref.query(q, top_k=5), port.query(q, top_k=5))


@pytest.mark.parametrize("s", [2, 3])
def test_sharded_spill_stays_exact(s):
    rng = np.random.default_rng(15)
    sigs = rng.integers(0, 1 << 16, (10, K), dtype=np.int32)
    sigs[s] = sigs[0]           # shard 0, width-1 bucket -> doc s spills
    ref, port = _sharded_pair(s, cfg=dict(bucket_width=1,
                                          auto_rebuild=False))
    ref.add(sigs)
    port.add(sigs)
    assert port.n_spilled == ref.n_spilled > 0
    _same(ref.query(sigs[[0, 3]], top_k=4), port.query(sigs[[0, 3]],
                                                         top_k=4))


def test_sharded_guards():
    cfg = StoreConfig(k=K, n_bands=NB, rows_per_band=R)
    with pytest.raises(ValueError):
        ShardedSketchStore(cfg, 0, device="cpu")
    with pytest.raises(ValueError):
        ShardedSketchStore(cfg, 2, partition="nope", device="cpu")
    sh = ShardedSketchStore(cfg, 2, device="cpu")
    sh.add(_corpus_sigs(n=8))
    with pytest.raises(NotImplementedError):
        sh.candidate_pairs()               # cross-shard pairs unrepresentable
    cfg_np = StoreConfig(k=K, n_bands=NB, rows_per_band=R,
                         store_signatures=False)
    with pytest.raises(RuntimeError):
        ShardedSketchStore(cfg_np, 2, device="cpu").query(
            np.zeros((1, K), np.int32))
    ref, port = _sharded_pair(1)
    ref.add(_corpus_sigs(n=20, seed=2))
    port.add(_corpus_sigs(n=20, seed=2))
    assert np.array_equal(port.candidate_pairs(), ref.candidate_pairs())


def test_partial_write_poisons_plane():
    """A shard that fails after another indexed its slice, or that wrote
    part of its own, poisons the plane; a clean failure at the first shard
    touched does not.  The reference's plane behaves the same."""
    cfg = StoreConfig(k=K, n_bands=NB, rows_per_band=R)

    class FailingShard(InProcessShard):
        def add(self, sigs):
            raise ConnectionError("worker died mid-batch")

    class DirtyShard(InProcessShard):
        def add(self, rows):
            self.store.add(rows[: len(rows) // 2])   # half landed
            err = ConnectionError("worker died mid-write")
            err.dirty = True
            raise err

    def plane(*kinds):
        return ShardedSketchStore(cfg, backends=[
            k(cfg, device="cpu") for k in kinds], device="cpu")

    sigs = _corpus_sigs(n=20)
    sharded = plane(InProcessShard, FailingShard)
    with pytest.raises(ConnectionError):
        sharded.add(sigs)
    for call in (lambda: sharded.add(sigs),
                 lambda: sharded.query(sigs[:2], top_k=3),
                 lambda: sharded.save("never-written")):
        with pytest.raises(RuntimeError, match="inconsistent"):
            call()
    sharded2 = plane(FailingShard, InProcessShard)
    with pytest.raises(ConnectionError):
        sharded2.add(sigs)                 # fails at shard 0, pre-write
    ids, _ = sharded2.query(sigs[:2], top_k=3)     # not poisoned
    assert (ids == -1).all()
    sharded3 = plane(DirtyShard, InProcessShard)
    with pytest.raises(ConnectionError):
        sharded3.add(sigs)
    with pytest.raises(RuntimeError, match="inconsistent"):
        sharded3.add(sigs)


@pytest.mark.parametrize("partition", ["round_robin", "hash"])
def test_sharded_save_load_roundtrip(partition, tmp_path):
    """A plane snapshot restores answers, gid maps and the partitioner, and
    ingest goes on with arrival-order ids, in the port as in the
    reference."""
    sigs = _corpus_sigs(n=140, seed=12)
    ref, port = _sharded_pair(3, partition=partition)
    ref.add(sigs)
    port.add(sigs)
    d = str(tmp_path / "plane")
    port.save(d)
    re = ShardedSketchStore.load(d, device="cpu")
    assert (re.n_shards, re.partition, re.n_items) == (3, partition, 140)
    assert np.array_equal(re.shard_sizes(), port.shard_sizes())
    q = _queries(sigs, seed=13)
    _same(ref.query(q, top_k=5), re.query(q, top_k=5))
    more = _corpus_sigs(n=25, seed=14)
    assert np.array_equal(re.add(more), ref.add(more))
    _same(ref.query(q, top_k=5), re.query(q, top_k=5))


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("b", [2, 32])
def test_plane_snapshots_cross_load_both_ways(s, b, tmp_path):
    sigs = _corpus_sigs(n=150, seed=16)
    ref, port = _sharded_pair(s, partition="hash", cfg=dict(b=b))
    ref.add(sigs)
    port.add(sigs)
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref.save(rdir)
    port.save(pdir)
    assert sorted(os.listdir(rdir)) == sorted(os.listdir(pdir))
    assert _npz_layout(os.path.join(rdir, MANIFEST_FILE)) == \
        _npz_layout(os.path.join(pdir, MANIFEST_FILE))
    for i in range(s):
        assert _npz_layout(shard_snapshot_path(rdir, i)) == \
            _npz_layout(shard_snapshot_path(pdir, i))
    q = _queries(sigs, seed=17)
    want = ref.query(q, top_k=5)
    a = ShardedSketchStore.load(rdir, device="cpu")
    c = RefSharded.load(pdir)
    _same(want, a.query(q, top_k=5))
    _same(want, c.query(q, top_k=5))
    ref_back = RefSharded.load(rdir)
    for i in range(s):
        want_digest = ref.shards[i].store.digest()
        assert a.shards[i].store.digest() == want_digest
        assert c.shards[i].store.digest() == want_digest
        _assert_tables_equal(ref_back.shards[i].store.table,
                             a.shards[i].store.table)


def test_sharded_load_backend_count_guard(tmp_path):
    cfg = StoreConfig(k=K, n_bands=NB, rows_per_band=R)
    sharded = ShardedSketchStore(cfg, 2, device="cpu")
    sharded.add(_corpus_sigs(n=20))
    d = str(tmp_path / "plane")
    sharded.save(d)
    with pytest.raises(ValueError):
        ShardedSketchStore.load(d, backends=[InProcessShard(cfg,
                                                            device="cpu")])
    with pytest.raises(ValueError):
        RefSharded.load(d, backends=[RefInProcessShard(RefStoreConfig(
            k=K, n_bands=NB, rows_per_band=R))])


# -- pipelined ingest (the service, ``tests/test_ingest.py``) ----------------

D = 1 << 12
BATCH = 16


def _docs(n=96, nnz=40, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, D, (n, nnz), np.int32), axis=1)
    idx[-5:] = idx[:5]                    # planted duplicates
    return idx


def _services(b=32, **kw):
    common = dict(d=D, k=K, n_bands=NB, rows_per_band=R, b=b, **kw)
    ref = RefService(RefSearchConfig(**common))
    params = convert.permutations_from_jax(np.asarray(ref.engine.sigma),
                                           np.asarray(ref.engine.pi), "cpu")
    port = SimilaritySearchService(SearchConfig(device="cpu", **common),
                                   params=params)
    return ref, port


@pytest.mark.parametrize("s,b", [(1, 32), (2, 2), (4, 32), (2, 1)])
def test_pipelined_ingest_bit_identical(s, b):
    """The port's pipelined ingest answers as the reference's serial
    ingest, raw (b = 1, 2 at 4 rows a band) or packed."""
    docs = _docs(seed=s)
    ref, port = _services(b=b, n_shards=s)
    assert port.packed_ingest == ref.packed_ingest == (b == 32)
    for lo in range(0, len(docs), BATCH):
        ref.add_sparse(docs[lo: lo + BATCH])
    with port.pipeline(depth=3) as pipe:
        for lo in range(0, len(docs), BATCH):
            pipe.submit(docs[lo: lo + BATCH])
    assert len(pipe) == 0 and pipe.timings["n_items"] == len(docs)
    _same(ref.query_sparse(docs[:20], top_k=5),
          port.query_sparse(docs[:20], top_k=5), (s, b))


def test_pipeline_depth_one_is_serial_and_deeper_is_identical():
    docs = _docs(seed=9)
    ref, _ = _services(b=2, n_shards=2)
    ref.add_sparse(docs)
    want = ref.query_sparse(docs[:16], top_k=4)
    for depth in (1, 2, 5):
        _, port = _services(b=2, n_shards=2)
        pipe = port.pipeline(depth=depth)
        for lo in range(0, len(docs), BATCH):
            pipe.submit(docs[lo: lo + BATCH])
            assert len(pipe) < max(depth, 2)
        pipe.flush()
        _same(want, port.query_sparse(docs[:16], top_k=4), depth)


def test_pipeline_rejects_bad_config_and_empty_index():
    _, port = _services(b=2)
    with pytest.raises(ValueError, match="depth"):
        port.pipeline(depth=0)
    with pytest.raises(ValueError, match="layout"):
        port.pipeline(layout="csr")
    with pytest.raises(ValueError, match="empty index"):
        port.query_sparse(_docs(n=2))
    port.add_sparse(_docs(n=8))
    ids, _ = port.query_sparse(_docs(n=8)[:3], top_k=1)
    assert np.array_equal(ids[:, 0], np.arange(3))


@pytest.mark.parametrize("saved_by", ["port", "reference"])
def test_service_serves_a_loaded_snapshot(saved_by, tmp_path):
    """A plane snapshot, written by either package, served by a port
    service with the same permutations (``store=``), answers as the
    reference service that was saved."""
    docs = _docs(seed=3)
    ref, port = _services(b=2, n_shards=3, partition="hash")
    ref.add_sparse(docs)
    port.add_sparse(docs)
    d = str(tmp_path / "plane")
    (port if saved_by == "port" else ref).store.save(d)
    loaded = SimilaritySearchService(
        port.cfg, params=(port.engine.sigma, port.engine.pi),
        store=ShardedSketchStore.load(d, device="cpu"))
    assert loaded.size == len(docs) and not loaded.packed_ingest
    _same(ref.query_sparse(docs[:20], top_k=5),
          loaded.query_sparse(docs[:20], top_k=5), saved_by)
