"""The serving slice as a whole: the port's service against the JAX one.

Both services index the same ``corpus_with_duplicates`` corpus with the
same two permutations (carried across by ``permutations_from_jax``) through
``pipeline(depth)``, then answer the same queries: indexed documents, fresh
documents that take the brute-force fallback, and (with bucket_width=1)
spilled keys.  ids, scores, size and shard sizes must be identical
(scores are count.float32 / k on both sides: tolerance 0).  The replicated
tcp plane (two shards of two CPU workers, the journal, the supervisor)
answers the same way before and after a worker is killed and respawned.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.data.shingle import batch_shingles
from repro.data.synthetic import corpus_with_duplicates
from repro.kernels.packfmt import pack_codes
from repro.serve.search import SearchConfig as RefSearchConfig
from repro.serve.search import SimilaritySearchService as RefService
from repro.store import SketchStore as RefStore
from repro.store import StoreConfig as RefStoreConfig
from repro_torch import convert
from repro_torch.data.shingle import batch_shingles as t_batch_shingles
from repro_torch.data.synthetic import \
    corpus_with_duplicates as t_corpus_with_duplicates
from repro_torch.device import u32_to_device
from repro_torch.kernels import lsh_probe as t_probe
from repro_torch.kernels import query_fused as t_qf
from repro_torch.serve.search import SearchConfig, SimilaritySearchService
from repro_torch.store import SketchStore, StoreConfig
from repro_torch.transport.wire import Message, MsgType

D, K, NB, R = 1 << 12, 64, 16, 4
BATCH = 32


def _corpus():
    docs, _ = corpus_with_duplicates(192, vocab=3000, doc_len=64,
                                     dup_fraction=0.5, seed=0)
    fresh, _ = corpus_with_duplicates(8, vocab=3000, doc_len=64, seed=99)
    idx = batch_shingles(docs, n=3, d=D, max_nnz=64)
    qidx = np.concatenate([idx[:24],
                           batch_shingles(fresh, n=3, d=D, max_nnz=64)])
    return idx, qidx


def _ingest(svc, idx, depth):
    with svc.pipeline(depth=depth) as pipe:
        for lo in range(0, len(idx), BATCH):
            pipe.submit(idx[lo: lo + BATCH])


def _case(s, depth, ref_q, port_q, bw, partition, b=32, top_k=5):
    # the b = 32 cases keep the ids they had before b and top_k were
    # parameters
    tag = f"{s}-{depth}-{ref_q}-{port_q}-{bw}-{partition}"
    if (b, top_k) != (32, 5):
        tag += f"-b{b}-top{top_k}"
    return pytest.param(s, depth, ref_q, port_q, bw, partition, b, top_k,
                        id=tag)


@pytest.mark.parametrize("s,depth,ref_q,port_q,bw,partition,b,top_k", [
    _case(1, 1, "jnp", "auto", 8, "round_robin"),
    _case(1, 2, "host", "auto", 1, "round_robin"),
    _case(3, 1, "host", "host", 8, "hash"),
    _case(3, 2, "jnp", "auto", 1, "round_robin"),
    # b < 32: raw ingest at 4 rows a band (b = 1, 2, 4), packed (8, 16)
    _case(1, 2, "jnp", "auto", 8, "round_robin", b=1),
    _case(3, 1, "host", "auto", 1, "hash", b=2),
    _case(3, 2, "jnp", "host", 8, "round_robin", b=2),
    _case(1, 1, "host", "auto", 1, "round_robin", b=4),
    _case(3, 2, "jnp", "auto", 8, "hash", b=8),
    _case(1, 2, "jnp", "auto", 1, "round_robin", b=16),
    # top_k past every row's candidate count (and, at 200, past the index)
    _case(3, 2, "jnp", "auto", 8, "round_robin", b=2, top_k=40),
    _case(1, 1, "jnp", "auto", 1, "round_robin", top_k=200),
])
def test_service_answers_like_the_reference(s, depth, ref_q, port_q, bw,
                                            partition, b, top_k):
    idx, qidx = _corpus()
    common = dict(d=D, k=K, n_bands=NB, rows_per_band=R, n_shards=s,
                  bucket_width=bw, partition=partition, b=b)
    ref = RefService(RefSearchConfig(query_impl=ref_q, **common))
    params = convert.permutations_from_jax(np.asarray(ref.engine.sigma),
                                           np.asarray(ref.engine.pi), "cpu")
    port = SimilaritySearchService(
        SearchConfig(query_impl=port_q, device="cpu", **common),
        params=params)
    assert port.packed_ingest == ref.packed_ingest == (R % (32 // b) == 0)
    _ingest(ref, idx, depth)
    _ingest(port, idx, depth)
    assert port.size == ref.size == len(idx)
    assert np.array_equal(port.store.shard_sizes(), ref.store.shard_sizes())
    want_ids, want_scores = ref.query_sparse(qidx, top_k=top_k)
    got_ids, got_scores = port.query_sparse(qidx, top_k=top_k)
    assert got_ids.dtype == np.int64 and got_scores.dtype == np.float32
    assert got_ids.shape == (len(qidx), top_k)
    assert np.array_equal(got_ids, want_ids)
    assert np.array_equal(got_scores, want_scores)
    assert (got_ids[:24, 0] == np.arange(24)).all()         # self-hits
    assert (got_scores[:24, 0] == 1.0).all()
    assert port.store.last_timings["n_fallback"] > 0        # fresh docs
    if top_k > 5:
        assert (got_ids[:24] == -1).any()       # fewer candidates than k
    if bw == 1:
        assert port.store.n_spilled > 0


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
def test_service_serves_every_b_at_the_default_bands(b):
    """K = 256 in 32 bands of 8 rows, the serving defaults: b = 1 and 2
    take the raw-signature path, b >= 4 the packed one; the answers are
    the JAX service's."""
    docs, _ = corpus_with_duplicates(96, vocab=3000, doc_len=64,
                                     dup_fraction=0.5, seed=b)
    idx = batch_shingles(docs, n=3, d=D, max_nnz=64)
    fresh = np.sort(np.random.default_rng(b).integers(0, D, (4, 64),
                                                      np.int32), axis=1)
    qidx = np.concatenate([idx[:12], fresh])
    ref = RefService(RefSearchConfig(d=D, b=b))
    params = convert.permutations_from_jax(np.asarray(ref.engine.sigma),
                                           np.asarray(ref.engine.pi), "cpu")
    port = SimilaritySearchService(SearchConfig(d=D, b=b, device="cpu"),
                                   params=params)
    assert (port.cfg.k, port.cfg.n_bands, port.cfg.rows_per_band) == \
        (256, 32, 8)
    assert port.packed_ingest == ref.packed_ingest == (b >= 4)
    _ingest(ref, idx, 2)
    _ingest(port, idx, 2)
    got = port.query_sparse(qidx, top_k=5)
    want = ref.query_sparse(qidx, top_k=5)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert (got[0][:12, 0] == np.arange(12)).all()          # self-hits
    assert (got[1][:12, 0] == 1.0).all()
    assert port.store.last_timings["n_fallback"] > 0


@pytest.mark.parametrize("bw", [8, 1])
def test_service_probes_the_folds_hashes_where_they_lie(monkeypatch, bw):
    """The service's query leg on the fused path, with the host operand
    function patched to raise: the shards probe the coordinator's hashes
    where the fold wrote them.  With no spilled entry (bw = 8) no hash is
    copied to the host; with spilled entries (bw = 1) the spill leg's host
    copy is made once a query batch, for all three shards.  Answers equal
    the JAX service's."""
    def refuse(*a, **kw):
        raise AssertionError("probe_operands on the query path")
    copies = []
    to_host = t_qf.hashes_to_host

    def counted(h):
        if bw == 8:
            raise AssertionError("band hashes copied to the host")
        copies.append(h.shape)
        return to_host(h)
    monkeypatch.setattr(t_probe, "probe_operands", refuse)
    monkeypatch.setattr(t_qf, "hashes_to_host", counted)
    idx, qidx = _corpus()
    common = dict(d=D, k=K, n_bands=NB, rows_per_band=R, n_shards=3,
                  bucket_width=bw)
    ref = RefService(RefSearchConfig(query_impl="jnp", **common))
    params = convert.permutations_from_jax(np.asarray(ref.engine.sigma),
                                           np.asarray(ref.engine.pi), "cpu")
    port = SimilaritySearchService(SearchConfig(device="cpu", **common),
                                   params=params)
    _ingest(ref, idx, 2)
    _ingest(port, idx, 2)
    assert (port.store.n_spilled > 0) == (bw == 1)
    for _ in range(2):
        got = port.query_sparse(qidx, top_k=5)
        want = ref.query_sparse(qidx, top_k=5)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    assert port.store.last_timings["n_fallback"] > 0
    assert len(copies) == (2 if bw == 1 else 0)


def test_port_data_helpers_match_reference():
    docs, labels = corpus_with_duplicates(40, vocab=500, doc_len=32, seed=4)
    tdocs, tlabels = t_corpus_with_duplicates(40, vocab=500, doc_len=32,
                                              seed=4)
    assert np.array_equal(labels, tlabels)
    assert all(np.array_equal(a, b) for a, b in zip(docs, tdocs))
    assert np.array_equal(batch_shingles(docs, n=3, d=D),
                          t_batch_shingles(tdocs, n=3, d=D))


@pytest.mark.parametrize("n_slots,bw", [(64, 1), (2048, 8), (96, 8)])
def test_store_query_packed_matches_reference(n_slots, bw):
    """The single store's own fused path (device fold + device meta at
    pow2 n_slots, the host walk otherwise) with spills and fallback rows."""
    rng = np.random.default_rng(n_slots)
    sigs = rng.integers(0, 6, (150, K), dtype=np.int32)
    sigs[100:] = sigs[:50]                                  # duplicates
    words = np.asarray(pack_codes(jnp.asarray(sigs), 32))
    cfg = dict(k=K, n_bands=NB, rows_per_band=R, n_slots=n_slots,
               bucket_width=bw)
    ref = RefStore(RefStoreConfig(**cfg), query_impl="jnp")
    port = SketchStore(StoreConfig(**cfg), device="cpu")
    for lo in range(0, 150, 50):
        assert np.array_equal(port.add_packed(words[lo: lo + 50]),
                              ref.add_packed(words[lo: lo + 50]))
    assert port.table.n_slots == ref.table.n_slots
    assert port.n_spilled == ref.n_spilled
    q = np.concatenate([words[:20], rng.integers(
        0, 2**32, (4, K), dtype=np.uint32)])                # 4 fallbacks
    want = ref.query_packed(q, top_k=4)
    for arg in (q, u32_to_device(q, port.device)):
        got = port.query_packed(arg, top_k=4)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("b", [32, 2])
def test_replicated_service_answers_like_the_reference(tmp_path, b):
    """``transport="tcp", n_replicas=2, journal_dir=...`` on the CPU: two
    shards of two port workers each, the journal and the supervisor.  The
    answers are the JAX service's, before and after a worker is killed and
    the supervisor (on the service's device) respawns it, replays the
    journal and brings it back; ``close()`` leaves no live worker, the
    respawned one included."""
    idx, qidx = _corpus()
    common = dict(d=D, k=K, n_bands=NB, rows_per_band=R, n_shards=2, b=b)
    ref = RefService(RefSearchConfig(**common))
    params = convert.permutations_from_jax(np.asarray(ref.engine.sigma),
                                           np.asarray(ref.engine.pi), "cpu")
    port = SimilaritySearchService(
        SearchConfig(transport="tcp", n_replicas=2,
                     journal_dir=str(tmp_path), device="cpu", **common),
        params=params)
    handles = list(port._workers)
    try:
        assert port.packed_ingest == (b == 32)
        _ingest(ref, idx, 2)
        _ingest(port, idx, 2)
        want = ref.query_sparse(qidx, top_k=5)
        got = port.query_sparse(qidx, top_k=5)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert port.store.last_timings["n_fallback"] > 0
        assert port.store.journal.last_seq == -(-len(idx) // BATCH) - 1
        lane = port.store.shards[1].lanes[0]
        lane.handle.terminate()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and (
                lane.handle in handles or not lane.up):
            time.sleep(0.1)
        assert lane.handle not in handles and lane.up, lane.why_down
        handles.append(lane.handle)
        stats = lane.conn.request(Message(MsgType.STATS, {}))
        assert str(stats["device"]) == "cpu"
        assert int(stats["size"]) == port.store._gid_len[1]
        got = port.query_sparse(qidx, top_k=5)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    finally:
        port.close()
    assert not any(h.alive for h in handles)
