"""The port's query-side kernels' plain versions against the JAX package.

Fold vs ``fold_planes_jnp`` and the host ``_poly_fold``; device probe meta
vs ``meta_from_planes``; the probe vs ``lsh_probe_jnp`` over records built
by the reference ``BandedLSHTable`` (sentinel hashes, a rebuilt wider
table); collision counts vs ``ops.collision_counts`` and the packed
counts vs ``ops.packed_collision_counts`` at every pack width;
``score_topk`` vs the reference scorer.  One interpret-mode Pallas case per kernel.  All outputs
are integers or count/k floats: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lsh import band_hashes, band_hashes_packed
from repro.kernels import collision_kernel as ref_coll
from repro.kernels import lsh_probe as ref_probe
from repro.kernels import ops as ref_ops
from repro.kernels import packfmt as ref_packfmt
from repro.kernels import query_fused as ref_qf
from repro.store import BandedLSHTable as RefTable
from repro_torch.device import u32_to_device
from repro_torch.kernels import collision_kernel as t_coll
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels import lsh_probe as t_probe
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import query_fused as t_qf
from repro_torch.kernels.packfmt import PACK_BITS
from repro_torch.store.table import BandedLSHTable

CPU = torch.device("cpu")


def _ref_fold(hi, lo):
    fh, fl = ref_qf.fold_planes_jnp(hi, lo)
    return ref_qf.planes_to_hashes(np.asarray(fh), np.asarray(fl))


# -- fold --------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_fold_words_matches_reference(seed):
    rng = np.random.default_rng(seed)
    nb, wpb, b = int(rng.integers(1, 33)), int(rng.integers(1, 9)), 5
    words = rng.integers(0, 2**32, (b, nb * wpb), dtype=np.uint32)
    words[0, :wpb] = 2**32 - 1                   # all-ones band
    hi, lo = ref_qf.words_to_planes(jnp.asarray(words), nb)
    want = _ref_fold(hi, lo)
    assert np.array_equal(want, band_hashes_packed(words, nb))
    rows = t_qf.words_to_rows(u32_to_device(words, CPU), nb)
    got = t_qf.hashes_to_host(t_qf.fold_rows_kernel(rows))
    assert np.array_equal(got, want)
    assert np.array_equal(t_qf.hashes_to_host(
        t_dispatch.fold_hashes(u32_to_device(words, CPU), n_bands=nb)), want)


@pytest.mark.parametrize("nb,r", [(8, 3), (5, 7), (1, 13), (16, 1)])
def test_fold_negative_codes_sign_extend(nb, r):
    rng = np.random.default_rng(nb * r)
    sig = rng.integers(-2**31, 2**31, (6, nb * r), dtype=np.int64) \
        .astype(np.int32)
    hi, lo = ref_qf.sig_to_planes(jnp.asarray(sig), nb, r)
    want = _ref_fold(hi, lo)
    assert np.array_equal(want, band_hashes(sig, nb, r))
    rows = t_qf.sig_to_rows(torch.tensor(sig), nb, r)
    got = t_qf.fold_rows_kernel(rows, sign_extend=True)
    assert np.array_equal(t_qf.hashes_to_host(got), want)


def test_fold_matches_pallas_kernel_interpret():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2**32, (3, 16), dtype=np.uint32)
    hi, lo = ref_qf.words_to_planes(jnp.asarray(words), 4)
    fh, fl = ref_qf.fold_planes_pallas(hi, lo, block_q=2, interpret=True)
    want = ref_qf.planes_to_hashes(np.asarray(fh), np.asarray(fl))
    got = t_qf.fold_rows_kernel(t_qf.words_to_rows(
        u32_to_device(words, CPU), 4))
    assert np.array_equal(t_qf.hashes_to_host(got), want)


@pytest.mark.parametrize("n_slots", [16, 2048])
def test_meta_from_hashes_matches_reference(n_slots):
    rng = np.random.default_rng(n_slots)
    words = rng.integers(0, 2**32, (7, 12), dtype=np.uint32)
    hi, lo = ref_qf.fold_planes_jnp(*ref_qf.words_to_planes(
        jnp.asarray(words), 4))
    hi, lo = np.asarray(hi).copy(), np.asarray(lo).copy()
    hi[2, 1] = lo[2, 1] = 2**32 - 1              # the sentinel key
    want = np.asarray(ref_qf.meta_from_planes(
        jnp.asarray(hi), jnp.asarray(lo), n_slots=n_slots))
    h = torch.tensor(ref_qf.planes_to_hashes(hi, lo).view(np.int64))
    got = t_qf.meta_from_hashes(h, n_slots=n_slots)
    assert np.array_equal(got.numpy(), want)
    hashes = ref_qf.planes_to_hashes(hi, lo)
    assert np.array_equal(t_probe.probe_operands(hashes, n_slots),
                          ref_probe.probe_operands(hashes, n_slots))
    with pytest.raises(ValueError, match="pow2"):
        t_qf.meta_from_hashes(h, n_slots=24)


# -- probe -------------------------------------------------------------------

def _loaded_ref_table(ns, w, mp, nb, n=260, seed=2):
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 40, (n, nb * 4), dtype=np.int32)  # forced clashes
    hashes = band_hashes(sigs, nb, 4)
    hashes[5, 0] = ref_probe.SENTINEL_KEY        # sentinel hash -> spill
    t = RefTable(nb, n_slots=ns, bucket_width=w, max_probes=mp)
    t.insert(hashes[: n // 2], np.arange(n // 2))
    t.insert(hashes[n // 2:], np.arange(n // 2, n))
    return t, hashes


def _queries(hashes, nb):
    qh = hashes[:70].copy()
    qh[3, 1] = ref_probe.SENTINEL_KEY            # must match nothing
    rng = np.random.default_rng(9)
    qh[60:] = rng.integers(0, 1 << 60, (10, nb)).astype(np.uint64)  # absent
    return qh


def _probe_both(ref_table, qh):
    flat = ref_table.records.reshape(-1, 2 + ref_table.bucket_width)
    meta = ref_probe.probe_operands(qh, ref_table.n_slots)
    want = np.asarray(ref_probe.lsh_probe_jnp(
        jnp.asarray(flat), jnp.asarray(meta), n_slots=ref_table.n_slots,
        max_probes=ref_table.max_probes))
    got = t_probe.lsh_probe_hashes_kernel(
        torch.tensor(flat), torch.from_numpy(qh.view(np.int64)),
        n_slots=ref_table.n_slots, max_probes=ref_table.max_probes)
    return want, got.numpy()


@pytest.mark.parametrize("ns,w,mp,nb", [(37, 3, 5, 5), (64, 2, 4, 4),
                                        (101, 7, 16, 8), (16, 1, 2, 3)])
def test_probe_matches_reference_over_reference_records(ns, w, mp, nb):
    ref_table, hashes = _loaded_ref_table(ns, w, mp, nb)
    qh = _queries(hashes, nb)
    want, got = _probe_both(ref_table, qh)
    assert np.array_equal(got, want)
    assert np.array_equal(got.reshape(len(qh), -1), ref_table.lookup(qh))


def test_probe_after_rebuild_to_a_wider_table():
    ref_table, hashes = _loaded_ref_table(32, 2, 3, 4)
    assert ref_table.n_spilled > 0
    ref_table.rebuild(n_slots=257, bucket_width=8, max_probes=16)
    want, got = _probe_both(ref_table, _queries(hashes, 4))
    assert got.shape[1] == 8
    assert np.array_equal(got, want)


def test_probe_matches_pallas_kernel_interpret():
    ref_table, hashes = _loaded_ref_table(16, 2, 4, 2, n=40)
    qh = hashes[:4]
    flat = ref_table.records.reshape(-1, 4)
    meta = ref_probe.probe_operands(qh, 16)
    want = np.asarray(ref_probe.lsh_probe_pallas(
        jnp.asarray(flat), jnp.asarray(meta), n_slots=16, max_probes=4,
        block_e=4, interpret=True))
    got = t_probe.lsh_probe_hashes_kernel(
        torch.tensor(flat), torch.from_numpy(qh.view(np.int64)),
        n_slots=16, max_probes=4)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("ns,w,mp,nb", [(37, 3, 5, 5), (16, 1, 2, 3)])
def test_port_table_state_and_lookups_match_reference(ns, w, mp, nb):
    ref_table, hashes = _loaded_ref_table(ns, w, mp, nb)
    table = BandedLSHTable(nb, n_slots=ns, bucket_width=w, max_probes=mp,
                           device="cpu")
    table.insert(hashes[:130], np.arange(130))
    table.insert(hashes[130:], np.arange(130, 260))
    assert np.array_equal(table.records, ref_table.records)
    assert table.n_spilled == ref_table.n_spilled
    qh = _queries(hashes, nb)
    want = ref_table.lookup(qh)
    assert np.array_equal(table.lookup(qh, impl="numpy"), want)
    assert np.array_equal(table.lookup(qh, impl="device"), want)
    assert np.array_equal(table.spilled_candidates(qh, cap=2),
                          ref_table.spilled_candidates(qh, cap=2))
    table.rebuild(n_slots=2 * ns, bucket_width=2 * w)
    ref_table.rebuild(n_slots=2 * ns, bucket_width=2 * w)
    assert np.array_equal(table.records, ref_table.records)


# -- probe from device hashes and from words (operands built in the probe) ---

SENTINEL = int(ref_probe.SENTINEL_KEY)


def _full_range_table(ns, w, mp, load, nb=3, seed=0):
    """A reference table loaded to ``load`` of its slots with full-range
    uint64 hashes (about half >= 2^63), duplicate keys (buckets of several
    ids) and one sentinel hash; queries: stored keys, absent keys, the
    sentinel and keys of 2^63 and above."""
    rng = np.random.default_rng(seed + ns + w + mp)
    n = max(8, int(load * ns))
    hashes = rng.integers(0, 2**64, (n, nb), dtype=np.uint64)
    hashes[n // 2: n // 2 + n // 8] = hashes[: n // 8]        # duplicates
    hashes[3, 1] = ref_probe.SENTINEL_KEY
    t = RefTable(nb, n_slots=ns, bucket_width=w, max_probes=mp)
    t.insert(hashes, np.arange(n))
    absent = rng.integers(0, 2**64, (12, nb), dtype=np.uint64)
    absent[0, 0] = ref_probe.SENTINEL_KEY
    absent[1] = 2**63 + np.arange(nb, dtype=np.uint64)
    qh = np.ascontiguousarray(np.concatenate([hashes, absent]))
    return t, qh


def _walk_reach(records, qh, ns, mp):
    """(last step each entry's early-exit walk reads, whether it wrapped
    past the table's end) over host records, as the port's table walks."""
    flat = records.reshape(-1, records.shape[-1])
    nb = qh.shape[1]
    key = qh.reshape(-1)
    base = (key % np.uint64(ns)).astype(np.int64)
    lin = np.tile(np.arange(nb) * ns, len(qh))
    key64 = key.view(np.int64)
    last = np.zeros(len(key), np.int64)
    wrapped = np.zeros(len(key), bool)
    active = key != ref_probe.SENTINEL_KEY
    for t in range(mp):
        slot = base + t * (t + 1) // 2
        wrapped |= active & (slot >= ns)
        k64 = flat[lin + slot % ns, :2].copy().view(np.int64)[:, 0]
        last[active] = t
        active &= (k64 != key64) & (k64 != -1)
    return last, wrapped


@pytest.mark.parametrize("ns,w,mp,load", [
    (2048, 8, 16, 0.93), (3001, 8, 16, 0.93), (2048, 3, 16, 0.6),
    (3001, 5, 16, 0.95), (2048, 8, 1, 0.5), (3001, 1, 1, 0.3)])
def test_probe_from_hashes_matches_reference(ns, w, mp, load):
    """The probe's plain version from int64 hashes (operands built with
    torch, unsigned mod for any n_slots) against ``probe_operands`` +
    ``lsh_probe_jnp``: pow2 and not, hashes >= 2^63, the sentinel, W even
    and odd, max_probes 1 and 16, a nearly full table."""
    t, qh = _full_range_table(ns, w, mp, load)
    assert (qh >= np.uint64(2**63)).any()
    flat = t.records.reshape(-1, 2 + w)
    want = np.asarray(ref_probe.lsh_probe_jnp(
        jnp.asarray(flat), jnp.asarray(ref_probe.probe_operands(qh, ns)),
        n_slots=ns, max_probes=mp))
    h = torch.from_numpy(qh.view(np.int64))
    got = t_probe.lsh_probe_hashes_kernel(torch.tensor(flat), h, n_slots=ns,
                                          max_probes=mp)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy().reshape(len(qh), -1), t.lookup(qh))
    meta = t_probe.hash_operands(h, ns)
    assert np.array_equal(meta.numpy(), ref_probe.probe_operands(qh, ns))
    assert (want >= 0).any() and (want < 0).all(axis=1).any()
    if load > 0.9 and mp == 16:                # chains past 4 steps, wraps
        last, wrapped = _walk_reach(t.records, qh, ns, mp)
        assert last.max() >= 4 and wrapped.any()


def test_probe_from_hashes_matches_pallas_kernel_interpret():
    t, qh = _full_range_table(61, 3, 16, 0.95)
    qh = np.ascontiguousarray(qh[::9][:7])
    assert (qh >= np.uint64(2**63)).any()
    flat = t.records.reshape(-1, 5)
    want = np.asarray(ref_probe.lsh_probe_pallas(
        jnp.asarray(flat), jnp.asarray(ref_probe.probe_operands(qh, 61)),
        n_slots=61, max_probes=16, block_e=8, interpret=True))
    got = t_probe.lsh_probe_hashes_kernel(
        torch.tensor(flat), torch.from_numpy(qh.view(np.int64)), n_slots=61,
        max_probes=16)
    assert np.array_equal(got.numpy(), want)
    assert (want >= 0).any()


@pytest.mark.parametrize("ns,w,mp", [(2048, 8, 16), (4096, 3, 16),
                                     (2048, 2, 1)])
def test_probe_from_words_matches_reference(ns, w, mp):
    """The words-in leg, the fold and then the probe from its hashes (two
    launches on the card), against the reference's device pipeline: fold
    planes, ``meta_from_planes``, ``lsh_probe_jnp``."""
    rng = np.random.default_rng(ns + w)
    nb, wpb = 4, 2
    words = rng.integers(0, 2**32, (900, nb * wpb), dtype=np.uint32)
    words[600:800] = words[:200]                              # duplicates
    t = RefTable(nb, n_slots=ns, bucket_width=w, max_probes=mp)
    t.insert(band_hashes_packed(words[:800], nb), np.arange(800))
    q = words[::5]                                            # 20 absent
    hi, lo = ref_qf.fold_planes_jnp(*ref_qf.words_to_planes(
        jnp.asarray(q), nb))
    flat = t.records.reshape(-1, 2 + w)
    want = np.asarray(ref_probe.lsh_probe_jnp(
        jnp.asarray(flat), ref_qf.meta_from_planes(hi, lo, n_slots=ns),
        n_slots=ns, max_probes=mp))
    rows = t_qf.words_to_rows(u32_to_device(q, CPU), nb)
    got = t_probe.lsh_probe_hashes_kernel(
        torch.tensor(flat), t_qf.fold_rows_kernel(rows), n_slots=ns,
        max_probes=mp)
    assert np.array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).all(axis=1).any()


@pytest.mark.parametrize("spilled", [False, True])
@pytest.mark.parametrize("with_hashes", [False, True])
def test_query_fused_matches_reference_dispatch(spilled, with_hashes):
    """``dispatch.query_fused`` from words (the fold kernel, then the probe
    from its hashes) and from the coordinator's device hashes, with and
    without a spill leg, against the reference's ``dispatch.query_fused``."""
    from repro.kernels import dispatch as ref_dispatch
    rng = np.random.default_rng(int(spilled) + 2 * int(with_hashes))
    k, b, nb, ns, w = 32, 8, 4, 512, 2
    codes = rng.integers(0, 3, (300, k), dtype=np.int32)
    codes[200:] = codes[:100]                                 # duplicates
    words = np.asarray(ref_packfmt.pack_codes(jnp.asarray(codes), b))
    t = RefTable(nb, n_slots=ns, bucket_width=w, max_probes=16)
    t.insert(band_hashes_packed(words, nb), np.arange(300))
    assert t.n_spilled > 0                          # a spill leg to take
    q = np.concatenate([words[:30], rng.integers(0, 2**32, (5, words.shape[1]),
                                                 dtype=np.uint32)])
    hashes = band_hashes_packed(q, nb)
    spill = (lambda h: t.spilled_candidates(h, cap=4)) if spilled else None
    want = ref_dispatch.query_fused(
        jnp.asarray(t.records.reshape(-1, 2 + w)), jnp.asarray(words),
        jnp.asarray(q), n_bands=nb, n_slots=ns, max_probes=16, k=k, b=b,
        top_k=4, impl="jnp", hashes=hashes if with_hashes else None,
        spill_lookup=spill)
    qdev = u32_to_device(q, CPU)
    band = (t_qf.BandHashes(t_dispatch.fold_hashes(qdev, n_bands=nb))
            if with_hashes else None)
    got = t_dispatch.query_fused(
        torch.tensor(t.records.reshape(-1, 2 + w)), u32_to_device(words, CPU),
        qdev, n_bands=nb, n_slots=ns, max_probes=16, k=k, b=b, top_k=4,
        hashes=band, spill_lookup=spill)
    for g, r in zip(got, want):
        assert np.array_equal(g, np.asarray(r))
    if with_hashes:
        assert np.array_equal(band.host(), hashes)


# -- collision counts --------------------------------------------------------

@pytest.mark.parametrize("q,n,k", [(1, 1, 1), (37, 53, 130), (64, 64, 33)])
def test_collision_counts_match_reference(q, n, k):
    rng = np.random.default_rng(q + n + k)
    a = rng.integers(0, 5, (q, k), dtype=np.int32)
    b = rng.integers(0, 5, (n, k), dtype=np.int32)
    b[0] = a[0]
    want = np.asarray(ref_ops.collision_counts(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = t_ops.collision_counts(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_collision_counts_match_pallas_kernel_interpret():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 3, (3, 40), dtype=np.int32)
    b = rng.integers(0, 3, (4, 40), dtype=np.int32)
    want = np.asarray(ref_coll.collision_count_pallas(
        jnp.asarray(a), jnp.asarray(b), block_q=2, block_n=2, block_k=16,
        interpret=True))
    got = t_coll.collision_counts_kernel(torch.tensor(a), torch.tensor(b))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", PACK_BITS)
def test_packed_collision_counts_in_blocks(b):
    """Every pack width, N = 50 above ``unpack_block_n`` = 16: the blocked
    CPU path against the reference's, counts and scores."""
    rng = np.random.default_rng(b)
    k = 40
    sq = rng.integers(0, 2**31, (5, k), dtype=np.int32)
    sn = rng.integers(0, 2**31, (50, k), dtype=np.int32)
    sn[3] = sq[1]
    wq = np.asarray(ref_packfmt.pack_codes(jnp.asarray(sq), b))
    wn = np.asarray(ref_packfmt.pack_codes(jnp.asarray(sn), b))
    want_counts = np.asarray(ref_ops.packed_collision_counts(
        jnp.asarray(wq), jnp.asarray(wn), k, b, unpack_block_n=16))
    want = np.asarray(ref_ops.packed_estimated_jaccard_matrix(
        jnp.asarray(wq), jnp.asarray(wn), k, b, unpack_block_n=16))
    got = t_ops.packed_estimated_jaccard_matrix(
        u32_to_device(wq, CPU), u32_to_device(wn, CPU), k, b)
    blocked = t_ops.packed_collision_counts(
        u32_to_device(wq, CPU), u32_to_device(wn, CPU), k, b,
        unpack_block_n=16)
    assert np.array_equal(blocked.numpy(), want_counts)
    assert int(want_counts[1, 3]) == k
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(blocked.numpy().astype(np.float32) / k, want)


@pytest.mark.parametrize("b", PACK_BITS)
@pytest.mark.parametrize("k", [1, 33])
def test_packed_collision_kernel_wrapper_on_cpu_matches_reference(b, k):
    """The packed wrapper on CPU tensors (its plain version: unpack, then
    count), K a multiple of 32/b or not, against the reference."""
    rng = np.random.default_rng(b + k)
    sq = rng.integers(0, 3, (7, k), dtype=np.int32)
    sn = rng.integers(0, 3, (20, k), dtype=np.int32)
    wq = np.asarray(ref_packfmt.pack_codes(jnp.asarray(sq), b))
    wn = np.asarray(ref_packfmt.pack_codes(jnp.asarray(sn), b))
    want = np.asarray(ref_ops.packed_collision_counts(
        jnp.asarray(wq), jnp.asarray(wn), k, b))
    got = t_coll.packed_collision_counts_kernel(
        u32_to_device(wq, CPU), u32_to_device(wn, CPU), k, b)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


# -- scorer ------------------------------------------------------------------

@pytest.mark.parametrize("b,top_k", [(32, 5), (4, 3), (32, 40)])
def test_score_topk_matches_reference(b, top_k):
    rng = np.random.default_rng(b + top_k)
    k, n, q = 32, 60, 9
    base = rng.integers(0, 4, (n, k), dtype=np.int32)   # many score ties
    words = np.asarray(ref_packfmt.pack_codes(jnp.asarray(base), b))
    qwords = words[rng.integers(0, n, q)]
    cand = rng.integers(-1, n, (q, 24)).astype(np.int32)
    cand[:, :4] = cand[:, 4:8]                           # duplicates
    cand[2] = -1                                         # no candidates
    want = ref_qf.score_topk(jnp.asarray(cand), jnp.asarray(words),
                             jnp.asarray(qwords), k=k, b=b, top_k=top_k)
    got = t_qf.score_topk(torch.tensor(cand), u32_to_device(words, CPU),
                          u32_to_device(qwords, CPU), k=k, b=b, top_k=top_k)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
