"""Dense signing in the PyTorch port, held bit for bit against the JAX package.

The two dense kernels' plain versions (int8 circulant min-reduce, bit-packed
set-bit walk) against the reference's Pallas kernels in interpret mode and
against its jnp oracle and ops; the dispatch policy; the engine; and the
dense serving slice as a whole (ingest, pipeline, query) against the JAX
service under the same permutations.  Every output is an integer or a
count.float32 / k score: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import SketchConfig as RefSketchConfig
from repro.core.engine import SketchEngine as RefSketchEngine
from repro.core.permutations import make_two_permutations as ref_perms
from repro.data.shingle import batch_shingles
from repro.data.synthetic import corpus_with_duplicates
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.cminhash_kernel import cminhash_pallas
from repro.kernels.cminhash_packed import cminhash_packed_pallas
from repro.kernels.cminhash_packed import pack_bits as ref_pack_bits
from repro.kernels.packfmt import PACK_BITS
from repro.serve.search import SearchConfig as RefSearchConfig
from repro.serve.search import SimilaritySearchService as RefService
from repro_torch import convert
from repro_torch.core.engine import SketchConfig, SketchEngine
from repro_torch.device import u32_to_host
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.cminhash_kernel import (cminhash_dense_kernel,
                                                 cminhash_dense_plain)
from repro_torch.kernels.cminhash_packed import (cminhash_packed,
                                                 cminhash_packed_kernel,
                                                 cminhash_packed_plain,
                                                 pack_bits, set_positions)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.search import SearchConfig, SimilaritySearchService

SENTINEL = 2 ** 31 - 1
# the reference dispatch sweeps (tests/test_dispatch.py): b % block_b,
# d % block_d, k < block_d, k % 32 all appear
DISPATCH_SHAPES = [(3, 100, 37, 0.05), (5, 300, 300, 0.3), (2, 257, 129, 0.9),
                   (4, 96, 7, 0.1), (1, 64, 64, 0.5)]
PACK_SHAPES = [(3, 100, 37, 0.05), (2, 257, 129, 0.3), (4, 96, 7, 0.1)]


def _rows(b, d, dens, seed, dtype=np.int8):
    """(B, D) rows, row 0 all zero; unset int32 entries are <= 0."""
    rng = np.random.default_rng(seed)
    on = rng.random((b, d)) < dens
    on[0] = False
    if dtype == np.bool_:
        return on
    if dtype == np.int32:
        return np.where(on, rng.integers(1, 9, (b, d)),
                        -rng.integers(0, 9, (b, d))).astype(np.int32)
    return on.astype(dtype)


def _pi(d, seed, with_sigma=False):
    sigma, pi = ref_perms(jax.random.PRNGKey(seed), d)
    return (np.asarray(sigma), np.asarray(pi)) if with_sigma \
        else np.asarray(pi)


def _same(port_out: torch.Tensor, ref_out, packed: bool) -> bool:
    got = port_out.numpy()
    want = np.asarray(ref_out)
    if packed:
        got = got.view(np.uint32)
    return got.dtype == want.dtype and np.array_equal(got, want)


# -- kernel 5 (int8) and kernel 6 (bit-packed) against the Pallas kernels -----

PALLAS_CASES = (
    # (B, D, K, dens, off, pack_b, dtype): shapes x offsets, then every
    # pack width, then the input types; row 0 is empty in every case
    [(3, 300, 200, 0.1, off, None, np.int8) for off in (0, 1)]
    + [(2, 70, 70, 0.3, off, None, np.int8) for off in (0, 1)]
    + [(2, 257, 129, 0.05, off, None, np.int8) for off in (0, 1)]
    + [(3, 300, 200, 0.1, i % 2, b, np.int8) for i, b in enumerate(PACK_BITS)]
    + [(2, 70, 70, 0.3, 1, 32, np.int8), (2, 257, 129, 0.05, 0, 4, np.int8)]
    + [(3, 300, 200, 0.1, 1, None, t) for t in (np.int32, np.bool_)]
    + [(2, 257, 129, 0.5, 0, 8, np.int32)])


@pytest.mark.parametrize("b,d,k,dens,off,pack_b,dtype", PALLAS_CASES)
def test_int8_plain_matches_pallas_kernel(b, d, k, dens, off, pack_b, dtype):
    v = _rows(b, d, dens, seed=b * d + k + off)
    pi = _pi(d, seed=d)
    want = cminhash_pallas(jnp.asarray(v), jnp.asarray(pi), k,
                           shift_offset=off, pack_b=pack_b, interpret=True)
    got = cminhash_dense_kernel(torch.tensor(v), torch.tensor(pi), k,
                                shift_offset=off, pack_b=pack_b)
    assert _same(got, want, pack_b is not None)
    if pack_b is None:
        assert (got[0] == SENTINEL).all()


@pytest.mark.parametrize("b,d,k,dens,off,pack_b,dtype", PALLAS_CASES)
def test_packed_plain_matches_pallas_kernel(b, d, k, dens, off, pack_b,
                                            dtype):
    v = _rows(b, d, dens, seed=b * d + k + off + 1)
    pi = _pi(d, seed=d + 1)
    want = cminhash_packed_pallas(jnp.asarray(v), jnp.asarray(pi), k,
                                  shift_offset=off, pack_b=pack_b,
                                  interpret=True)
    words = pack_bits(torch.tensor(v))
    got = cminhash_packed_kernel(words, torch.tensor(pi), k,
                                 shift_offset=off, pack_b=pack_b)
    assert _same(got, want, pack_b is not None)
    assert torch.equal(got, cminhash_packed(torch.tensor(v), torch.tensor(pi),
                                            k, shift_offset=off,
                                            pack_b=pack_b))


@pytest.mark.parametrize("d", [1, 31, 32, 70, 257, 1024])
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.bool_])
def test_pack_bits_matches_reference(d, dtype):
    v = _rows(4, d, 0.4, seed=d, dtype=dtype)
    want = np.asarray(ref_pack_bits(jnp.asarray(v)))
    got = pack_bits(torch.tensor(v))
    assert got.dtype == torch.int32
    assert np.array_equal(u32_to_host(got), want)


def test_set_positions_ignore_bits_past_d():
    words = torch.tensor([[-1, -1, -1], [0, 0, 0], [5, 0, 1 << 6]],
                         dtype=torch.int32)
    pos = set_positions(words, 70)
    assert pos.shape == (3, 70)
    assert pos[0].tolist() == list(range(70))
    assert (pos[1] == -1).all()
    assert pos[2, :3].tolist() == [0, 2, -1] and (pos[2, 2:] == -1).all()


# -- broader shapes against the reference's oracle and ops, no interpret ------

@pytest.mark.parametrize("b,d,k,dens", DISPATCH_SHAPES)
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("with_sigma", [False, True])
def test_dense_impls_match_reference_ops(b, d, k, dens, off, with_sigma):
    v = _rows(b, d, dens, seed=b * d + k + off)
    sigma, pi = _pi(d, seed=b + d, with_sigma=True)
    sig = sigma if with_sigma else None
    want = ref_ops.cminhash_signatures(
        jnp.asarray(v), jnp.asarray(pi), k,
        None if sig is None else jnp.asarray(sig), shift_offset=off,
        impl="ref")
    if sig is None:
        assert np.array_equal(np.asarray(want), np.asarray(
            ref_ref.cminhash_dense_ref(jnp.asarray(v), jnp.asarray(pi), k,
                                       shift_offset=off)))
    tv, tpi = torch.tensor(v), torch.tensor(pi)
    tsig = None if sig is None else torch.tensor(sig)
    for impl in ("int8", "packed", "auto"):
        got = t_ops.cminhash_signatures(tv, tpi, k, tsig, shift_offset=off,
                                        impl=impl)
        assert _same(got, want, False), impl
    if sig is None:
        assert torch.equal(cminhash_dense_plain(tv, tpi, k, shift_offset=off),
                           got)
        assert torch.equal(cminhash_packed_plain(pack_bits(tv), tpi, k,
                                                 shift_offset=off), got)
        assert torch.equal(t_ref.cminhash_dense_ref(tv, tpi, k,
                                                    shift_offset=off), got)


@pytest.mark.parametrize("b,d,k,dens", PACK_SHAPES)
@pytest.mark.parametrize("pack_b", PACK_BITS)
def test_fused_pack_matches_reference_ops(b, d, k, dens, pack_b):
    v = _rows(b, d, dens, seed=b + d + k)
    sigma, pi = _pi(d, seed=k, with_sigma=True)
    want = ref_ops.cminhash_signatures_packed(
        jnp.asarray(v), jnp.asarray(pi), k, pack_b, jnp.asarray(sigma),
        impl="ref")
    for impl in ("int8", "packed"):
        got = t_ops.cminhash_signatures_packed(
            torch.tensor(v), torch.tensor(pi), k, pack_b,
            torch.tensor(sigma), impl=impl)
        assert _same(got, want, True), impl


@pytest.mark.parametrize("q,n,k,b", [(3, 5, 37, 32), (4, 6, 64, 8),
                                     (2, 7, 33, 1)])
def test_ref_oracles_match_reference(q, n, k, b):
    rng = np.random.default_rng(q * n + k)
    sq = rng.integers(0, 5, (q, k), dtype=np.int32)
    sn = np.concatenate([sq[:1], rng.integers(0, 5, (n - 1, k),
                                              dtype=np.int32)])
    want = np.asarray(ref_ref.collision_count_ref(jnp.asarray(sq),
                                                  jnp.asarray(sn)))
    got = t_ref.collision_count_ref(torch.tensor(sq), torch.tensor(sn))
    assert np.array_equal(got.numpy(), want)
    wq = rng.integers(0, 2 ** 32, (q, -(-k * b // 32)), dtype=np.uint32)
    wn = np.concatenate([wq[:1] ^ np.uint32(1), rng.integers(
        0, 2 ** 32, (n - 1, wq.shape[1]), dtype=np.uint32)])
    want = np.asarray(ref_ref.packed_collision_count_ref(
        jnp.asarray(wq), jnp.asarray(wn), k, b))
    got = t_ref.packed_collision_count_ref(
        torch.tensor(wq.view(np.int32)), torch.tensor(wn.view(np.int32)),
        k, b)
    assert np.array_equal(got.numpy(), want)


# -- dispatch policy, counters, refusals --------------------------------------

@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_select_dense_impl_policy(device_type):
    assert dispatch.PACKED_MIN_D == 16384
    assert dispatch.select_dense_impl(16383, device_type) == "int8"
    assert dispatch.select_dense_impl(16384, device_type) == "packed"
    assert dispatch.select_dense_impl(1 << 16, device_type) == "packed"
    assert dispatch.select_dense_impl(2048, device_type) == "int8"


def test_dispatch_counts_routes_and_refuses_unknown_impls():
    reg = obs_metrics.default()
    v = torch.tensor(_rows(2, 64, 0.2, seed=0))
    pi = torch.tensor(_pi(64, seed=0))
    before = {n: reg.counter(f"kernel.dense.{n}.plain").value
              for n in ("int8", "packed")}
    dispatch.signatures_dense(v, pi, 16)
    dispatch.signatures_dense(v, pi, 16, impl="packed")
    assert reg.counter("kernel.dense.int8.plain").value == before["int8"] + 1
    assert reg.counter("kernel.dense.packed.plain").value \
        == before["packed"] + 1
    for impl in ("ref", "pallas"):
        with pytest.raises(ValueError, match="impl"):
            dispatch.signatures_dense(v, pi, 16, impl=impl)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dispatch.select_dense_impl(64, "tpu")
    with pytest.raises(ValueError, match="K <= D"):
        dispatch.signatures_dense(v, pi, 65)
    with pytest.raises(ValueError, match="shift_offset"):
        cminhash_dense_kernel(v, pi, 8, shift_offset=2)
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        cminhash_packed_kernel(v.to(torch.int32), pi, 8)


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("use_sigma", [True, False])
@pytest.mark.parametrize("pack_b", [None, *PACK_BITS])
def test_engine_dense_matches_reference_engine(use_sigma, pack_b):
    d, k = 300, 96
    ref = RefSketchEngine(RefSketchConfig(d=d, k=k, use_sigma=use_sigma,
                                          seed=3))
    params = convert.permutations_from_jax(np.asarray(
        make_sigma(ref)), np.asarray(ref.pi), "cpu")
    eng = SketchEngine(SketchConfig(d=d, k=k, use_sigma=use_sigma),
                       device="cpu", params=params)
    v = _rows(5, d, 0.08, seed=pack_b or 0)
    want = ref.sign(jnp.asarray(v), layout="dense", pack_b=pack_b)
    got = eng.sign(v, layout="dense", pack_b=pack_b)
    assert _same(got, want, pack_b is not None)


def make_sigma(ref_engine):
    """The reference engine's sigma (drawn even when it signs without)."""
    if ref_engine.sigma is not None:
        return ref_engine.sigma
    sigma, _ = ref_perms(jax.random.PRNGKey(ref_engine.cfg.seed),
                         ref_engine.cfg.d)
    return sigma


@pytest.mark.parametrize("d,k", [(1 << 10, 64), (1 << 14, 128)])
def test_engine_dense_agrees_with_sparse(d, k):
    """The same documents as dense rows and as index lists sign the same,
    on each side of the packed-kernel threshold."""
    docs, _ = corpus_with_duplicates(12, vocab=400, doc_len=40, seed=d)
    idx = batch_shingles(docs, n=3, d=d, max_nnz=48)
    v = np.zeros((len(idx), d), np.int8)
    rows = np.repeat(np.arange(len(idx)), idx.shape[1])
    ok = idx.reshape(-1) >= 0
    v[rows[ok], idx.reshape(-1)[ok]] = 1
    eng = SketchEngine(SketchConfig(d=d, k=k, seed=5), device="cpu")
    for pack_b in (None, 8, 32):
        assert torch.equal(eng.sign(v, layout="dense", pack_b=pack_b),
                           eng.sign(idx, layout="sparse", pack_b=pack_b))


# -- the dense serving slice as a whole ---------------------------------------

D, K, NB, R = 1 << 10, 64, 16, 4


def _dense_corpus():
    docs, _ = corpus_with_duplicates(300, vocab=2000, doc_len=48,
                                     dup_fraction=0.5, seed=2)
    fresh, _ = corpus_with_duplicates(8, vocab=2000, doc_len=48, seed=77)
    idx = batch_shingles(docs, n=3, d=D, max_nnz=48)
    fidx = batch_shingles(fresh, n=3, d=D, max_nnz=48)
    qidx = np.concatenate([idx[:24], fidx])
    return idx, qidx, _to_dense(idx), _to_dense(qidx)


def _to_dense(idx):
    v = np.zeros((len(idx), D), np.int8)
    rows = np.repeat(np.arange(len(idx)), idx.shape[1])
    ok = idx.reshape(-1) >= 0
    v[rows[ok], idx.reshape(-1)[ok]] = 1
    return v


@pytest.mark.parametrize("depth,s", [(2, 1), (1, 2)])
def test_dense_service_answers_like_the_reference(depth, s):
    idx, qidx, v, qv = _dense_corpus()
    common = dict(d=D, k=K, n_bands=NB, rows_per_band=R, n_shards=s)
    ref = RefService(RefSearchConfig(**common))
    params = convert.permutations_from_jax(np.asarray(ref.engine.sigma),
                                           np.asarray(ref.engine.pi), "cpu")
    port = SimilaritySearchService(SearchConfig(device="cpu", **common),
                                   params=params)
    for svc in (ref, port):
        svc.add_dense(v[:40])
        with svc.pipeline(depth=depth, layout="dense") as pipe:
            for lo in range(40, len(v), 64):
                pipe.submit(v[lo: lo + 64])
    assert port.size == ref.size == len(v)
    want_ids, want_scores = ref.query_dense(qv, top_k=5)
    got_ids, got_scores = port.query_dense(qv, top_k=5)
    assert got_ids.dtype == np.int64 and got_scores.dtype == np.float32
    assert np.array_equal(got_ids, want_ids)
    assert np.array_equal(got_scores, want_scores)
    assert (got_ids[:24, 0] == np.arange(24)).all()          # self-hits
    assert port.store.last_timings["n_fallback"] > 0         # fresh docs
    sparse_ids, sparse_scores = port.query_sparse(qidx, top_k=5)
    assert np.array_equal(got_ids, sparse_ids)
    assert np.array_equal(got_scores, sparse_scores)


def test_dense_ingest_equals_sparse_ingest():
    idx, _, v, _ = _dense_corpus()
    words = []
    for layout, data in (("dense", v), ("sparse", idx)):
        svc = SimilaritySearchService(SearchConfig(
            d=D, k=K, n_bands=NB, rows_per_band=R, device="cpu"))
        with svc.pipeline(depth=2, layout=layout) as pipe:
            for lo in range(0, len(data), 100):
                pipe.submit(data[lo: lo + 100])
        assert pipe.n_items == len(data) and pipe.n_batches == 3
        store = svc.store.shards[0].store
        words.append(store.buffer.device_words()[: store.size].clone())
    assert torch.equal(words[0], words[1])
    with pytest.raises(ValueError, match="layout"):
        svc.pipeline(layout="csr")
