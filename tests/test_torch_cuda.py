"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Edge shapes the serving path does not reach every day: K not a multiple of
32, empty index lists and rows, indices >= D, D past the uint16 range and
not a multiple of 32, K = D, every pack width, int8/int32/bool rows, row
offsets past 2^31, odd record strides; for the collision kernel, every
pack width, the codes past K in a row's last word, ragged tiles, negative
and sentinel codes, the whole serving index in one launch, outputs past
2^31 entries and counts past 2^24; for the signing kernels' window-min core
(sparse, dense int8 and bit-packed), D on both sides of each table
placement, rows longer than the compaction list, K past the hashes a lane
holds, set bits past D in the last word.  Integer outputs: tolerance 0.
Also: the wrappers refuse what the kernels do not take, and the service
answers the same on the card as on the CPU.  Imports neither jax nor repro,
so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.lsh import band_hashes, band_hashes_packed
from repro_torch.kernels import cminhash_kernel as kd
from repro_torch.kernels import cminhash_packed as kpk
from repro_torch.kernels import cminhash_sparse as ks
from repro_torch.kernels import collision_kernel as kc
from repro_torch.kernels import dispatch
from repro_torch.kernels import lsh_probe as kp
from repro_torch.kernels import ops
from repro_torch.kernels import query_fused as kq
from repro_torch.kernels.packfmt import PACK_BITS, pack_codes, pack_geometry
from repro_torch.store.table import BandedLSHTable

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _sparse_case(b, nnz, d, seed):
    gen = torch.Generator().manual_seed(seed)
    pi = torch.randperm(d, generator=gen).to(torch.int32)
    idx = torch.randint(-1, d, (b, nnz), generator=gen, dtype=torch.int32)
    if b > 1:
        idx[1] = -1                               # no valid index
    return idx, pi


@pytest.mark.parametrize("b,nnz,d,k", [(1, 1, 64, 1), (5, 0, 64, 31),
                                       (7, 37, 4096, 33),
                                       (300, 254, 1 << 16, 256),
                                       (9, 13, (1 << 16) + 3, 300)])
@pytest.mark.parametrize("off", [0, 1])
def test_sparse_kernel_matches_plain(cuda, b, nnz, d, k, off):
    idx, pi = _sparse_case(b, nnz, d, seed=b + d)
    want = ks.cminhash_sparse_plain(idx, pi, k, shift_offset=off)
    got = ks.cminhash_sparse_kernel(idx.to(cuda), pi.to(cuda), k,
                                    shift_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("d", [300, 1 << 16, (1 << 16) + 3])
@pytest.mark.parametrize("off", [0, 1])
def test_sparse_kernel_wraps_out_of_range_indices(cuda, d, off):
    """No sigma: indices >= D reach the kernel and wrap mod D, as in the
    plain version."""
    gen = torch.Generator().manual_seed(d + off)
    pi = torch.randperm(d, generator=gen).to(torch.int32)
    idx = torch.randint(-1, 4 * d, (33, 50), generator=gen,
                        dtype=torch.int32)
    idx[0, :3] = torch.tensor([d, 2 ** 31 - 1, d - 1])
    for pack_b in (None, 8):
        want = ks.cminhash_sparse_plain(idx, pi, 64, shift_offset=off,
                                        pack_b=pack_b)
        got = ks.cminhash_sparse_kernel(idx.to(cuda), pi.to(cuda), 64,
                                        shift_offset=off, pack_b=pack_b)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("pack_b", PACK_BITS)
@pytest.mark.parametrize("k", [1, 33, 256])
def test_sparse_kernel_fused_pack_matches_plain(cuda, pack_b, k):
    idx, pi = _sparse_case(6, 40, 4096, seed=pack_b)
    want = ks.cminhash_sparse_plain(idx, pi, k, pack_b=pack_b)
    got = ks.cminhash_sparse_kernel(idx.to(cuda), pi.to(cuda), k,
                                    pack_b=pack_b)
    assert torch.equal(got.cpu(), want)


def _dense_case(b, d, dens, seed):
    gen = torch.Generator().manual_seed(seed)
    pi = torch.randperm(d, generator=gen).to(torch.int32)
    v = (torch.rand((b, d), generator=gen) < dens).to(torch.int8)
    if b > 1:
        v[1] = 0                                  # an empty row
    return v, pi


DENSE_SHAPES = [(1, 1, 1, 0.5), (3, 70, 70, 0.3), (4, 257, 129, 0.05),
                (9, 300, 200, 0.1), (3, 100, 37, 0.0), (7, 4096, 33, 0.9),
                (33, 2048, 512, 0.5), (20, 1 << 16, 256, 0.004),
                (5, (1 << 16) + 3, 300, 0.01)]


@pytest.mark.parametrize("b,d,k,dens", DENSE_SHAPES)
@pytest.mark.parametrize("off", [0, 1])
def test_dense_kernels_match_plain(cuda, b, d, k, dens, off):
    v, pi = _dense_case(b, d, dens, seed=b + d + k)
    want = kd.cminhash_dense_plain(v, pi, k, shift_offset=off)
    got = kd.cminhash_dense_kernel(v.to(cuda), pi.to(cuda), k,
                                   shift_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    words = kpk.pack_bits(v.to(cuda))
    assert torch.equal(words.cpu(), kpk.pack_bits(v))
    got = kpk.cminhash_packed_kernel(words, pi.to(cuda), k, shift_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(
        kpk.cminhash_packed_plain(words.cpu(), pi, k, shift_offset=off), want)


@pytest.mark.parametrize("pack_b", PACK_BITS)
@pytest.mark.parametrize("k", [1, 33, 129, 256])
def test_dense_kernels_fused_pack_match_plain(cuda, pack_b, k):
    v, pi = _dense_case(6, 300, 0.1, seed=pack_b + k)
    want = kd.cminhash_dense_plain(v, pi, k, pack_b=pack_b)
    got = kd.cminhash_dense_kernel(v.to(cuda), pi.to(cuda), k,
                                   pack_b=pack_b)
    assert torch.equal(got.cpu(), want)
    got = kpk.cminhash_packed_kernel(kpk.pack_bits(v.to(cuda)), pi.to(cuda),
                                     k, pack_b=pack_b)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.bool])
def test_dense_kernels_read_every_input_type(cuda, dtype):
    v, pi = _dense_case(5, 257, 0.2, seed=3)
    rows = v.bool() if dtype == torch.bool else \
        torch.where(v > 0, 7, -(torch.arange(257) % 5)).to(dtype)
    want = kd.cminhash_dense_plain(v, pi, 100)
    for impl in ("int8", "packed"):
        got = dispatch.signatures_dense(rows.to(cuda), pi.to(cuda), 100,
                                        impl=impl)
        assert torch.equal(got.cpu(), want), impl


def test_dense_kernels_row_offsets_past_2_31(cuda):
    """B * D > 2^31: the last rows sit past the int32 byte offset."""
    b, d, k = 32_800, 1 << 16, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    v = torch.zeros((b, d), dtype=torch.int8, device=cuda)
    v.scatter_(1, torch.randint(0, d, (b, 40), generator=gen, device=cuda),
               1)
    pi = torch.randperm(d, generator=gen, device=cuda).to(torch.int32)
    tail = slice(b - 48, b)
    want = kd.cminhash_dense_plain(v[tail].cpu(), pi.cpu(), k, pack_b=32)
    got = kd.cminhash_dense_kernel(v, pi, k, pack_b=32)
    assert torch.equal(got[tail].cpu(), want)
    words = kpk.pack_bits(v)
    del v
    got = kpk.cminhash_packed_kernel(words, pi, k, pack_b=32)
    assert torch.equal(got[tail].cpu(), want)


def test_dense_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    v = torch.zeros((4, 64), dtype=torch.int8, device=cuda)
    pi = torch.arange(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kd.cminhash_dense_kernel(v.reshape(64, 4).t(), pi, 8)
    with pytest.raises(TypeError):
        kd.cminhash_dense_kernel(v, pi.long(), 8)
    with pytest.raises(ValueError, match="cuda|cpu"):
        kd.cminhash_dense_kernel(v, pi.cpu(), 8)
    words = kpk.pack_bits(v)
    with pytest.raises(TypeError):
        kpk.cminhash_packed_kernel(words.long(), pi, 8)
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        kpk.cminhash_packed_kernel(words[:, :1], pi, 8)


@pytest.mark.parametrize("d", [1 << 12, 1 << 14])
def test_dense_service_answers_the_same_on_card_and_cpu(cuda, d):
    """int8 route below PACKED_MIN_D, bit-packed at it."""
    from repro_torch.data.shingle import batch_shingles
    from repro_torch.data.synthetic import corpus_with_duplicates
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    docs, _ = corpus_with_duplicates(400, vocab=3000, doc_len=64, seed=1)
    idx = batch_shingles(docs, n=3, d=d, max_nnz=64)
    v = np.zeros((len(idx), d), np.int8)
    for i, row in enumerate(idx):
        v[i, row[row >= 0]] = 1
    answers = []
    for device in ("cuda", "cpu"):
        svc = SimilaritySearchService(SearchConfig(
            d=d, k=64, n_bands=16, rows_per_band=4, device=device))
        with svc.pipeline(depth=2, layout="dense") as pipe:
            for lo in range(0, 350, 70):
                pipe.submit(v[lo: lo + 70])
        answers.append(svc.query_dense(v[300:], top_k=5))
        assert np.array_equal(answers[-1][0],
                              svc.query_sparse(idx[300:], top_k=5)[0])
    assert np.array_equal(answers[0][0], answers[1][0])
    assert np.array_equal(answers[0][1], answers[1][1])


# Placement boundaries of csrc/window_fold.cuh.  The warps' lists take
# 16 x 1028 x 4 bytes; a block may have 232,448 bytes of shared memory; a
# shared table covers D + ext entries, ext = K rounded up to the hashes a
# pass covers (32 x 2, 8, 16 or 32 hashes a lane) + shift_offset; the pair
# table (K > 64) holds two copies of (D + ext) // 2 + 1 32-bit words.
_LIST_BYTES = 16 * 1028 * 4
_SHARED_MAX = 232_448


def _ext(k, off):
    span = 32 * next((h for h in (2, 8, 16) if 32 * h >= k), 32)
    return -(-k // span) * span + off


def _pair_limit(k, off):
    """The largest D whose pair table fits beside the lists."""
    d = (_SHARED_MAX - _LIST_BYTES) // 4
    while ((d + _ext(k, off)) // 2 + 1) * 8 + _LIST_BYTES > _SHARED_MAX:
        d -= 1
    return d


_K_PLACE = 100
PLACEMENT_DS = [_pair_limit(_K_PLACE, 1), _pair_limit(_K_PLACE, 1) + 1,
                1 << 16, (1 << 16) + 1]


def _signing_kernels(v, pi, k, cuda, **kw):
    """The dense int8, bit-packed and sparse kernels on the same rows, each
    against the dense plain version."""
    want = kd.cminhash_dense_plain(v, pi, k, **kw)
    got = kd.cminhash_dense_kernel(v.to(cuda), pi.to(cuda), k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    got = kpk.cminhash_packed_kernel(kpk.pack_bits(v).to(cuda), pi.to(cuda),
                                     k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    nnz = max(int((v > 0).sum(1).max()), 1)
    idx = torch.full((v.shape[0], nnz), -1, dtype=torch.int32)
    for r in range(v.shape[0]):
        pos = torch.nonzero(v[r] > 0).flatten().to(torch.int32)
        idx[r, :len(pos)] = pos
    assert torch.equal(ks.cminhash_sparse_plain(idx, pi, k, **kw), want)
    got = ks.cminhash_sparse_kernel(idx.to(cuda), pi.to(cuda), k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("d", PLACEMENT_DS)
@pytest.mark.parametrize("off", [0, 1])
def test_signing_kernels_on_both_sides_of_each_placement(cuda, d, off):
    """uint16 pairs up to their fit limit, the uint16 table past it and up
    to D = 65,536, pi in global memory past that."""
    v, pi = _dense_case(6, d, 0.003, seed=d + off)
    _signing_kernels(v, pi, _K_PLACE, cuda, shift_offset=off)


@pytest.mark.parametrize("off", [0, 1])
def test_table_too_large_for_shared_memory_reads_pi_from_global(cuda, off):
    """D = 65,536 with K = 20,000: the uint16 table with its 20,480 + off
    entries in front passes the shared limit, so pi is read from global
    memory at a D the uint16 table would cover.  Held against the sparse
    plain version (the dense one would take minutes at this K)."""
    d, k = 1 << 16, 20_000
    v, pi = _dense_case(3, d, 0.0002, seed=off)
    v[0, d - 1] = 1
    nnz = int((v > 0).sum(1).max())
    idx = torch.full((3, nnz), -1, dtype=torch.int32)
    for r in range(3):
        pos = torch.nonzero(v[r] > 0).flatten().to(torch.int32)
        idx[r, :len(pos)] = pos
    want = ks.cminhash_sparse_plain(idx, pi, k, shift_offset=off, pack_b=4)
    got = ks.cminhash_sparse_kernel(idx.to(cuda), pi.to(cuda), k,
                                    shift_offset=off, pack_b=4)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    got = kd.cminhash_dense_kernel(v.to(cuda), pi.to(cuda), k,
                                   shift_offset=off, pack_b=4)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("d", [2048, 3000])
def test_dense_kernel_all_ones_rows_with_k_equal_d(cuda, d):
    """Rows longer than the compaction list (1024 positions), K = D past
    the hashes a lane holds: folds mid-row and passes over q.  D = 3000
    scans a byte (the int8 kernel) or a word (the bit-packed one) per lane,
    D = 2048 sixteen bytes or four words."""
    gen = torch.Generator().manual_seed(d)
    pi = torch.randperm(d, generator=gen).to(torch.int32)
    v = torch.ones((3, d), dtype=torch.int8)
    v[1, ::3] = 0
    for pack_b in (None, 8):
        want = kd.cminhash_dense_plain(v, pi, d, pack_b=pack_b)
        got = kd.cminhash_dense_kernel(v.to(cuda), pi.to(cuda), d,
                                       pack_b=pack_b)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        got = kpk.cminhash_packed_kernel(kpk.pack_bits(v).to(cuda),
                                         pi.to(cuda), d, pack_b=pack_b)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("d", [2048, 1 << 16, (1 << 16) + 1])
def test_only_entry_at_d_minus_1_with_shift_offset_1(cuda, d):
    """The last position, read by every hash through the circular wrap."""
    gen = torch.Generator().manual_seed(d)
    pi = torch.randperm(d, generator=gen).to(torch.int32)
    v = torch.zeros((2, d), dtype=torch.int8)
    v[0, d - 1] = 1
    _signing_kernels(v, pi, min(d, 1100), cuda, shift_offset=1)


@pytest.mark.parametrize("d", [4096, 1 << 16])
@pytest.mark.parametrize("off", [0, 1])
def test_k_above_the_hashes_a_lane_holds(cuda, d, off):
    """K = 1100 > 32 x 32: two passes over q."""
    v, pi = _dense_case(5, d, 0.05, seed=d + off)
    _signing_kernels(v, pi, 1100, cuda, shift_offset=off)


@pytest.mark.parametrize("pack_b", PACK_BITS)
@pytest.mark.parametrize("d,k", [(2048, 512), (1 << 16, 256),
                                 ((1 << 16) + 1, 100), (4096, 1100)])
def test_signing_kernels_fused_pack_in_each_placement(cuda, pack_b, d, k):
    v, pi = _dense_case(4, d, 0.02, seed=pack_b + d)
    _signing_kernels(v, pi, k, cuda, pack_b=pack_b)


@pytest.mark.parametrize("d", [33, 1000, 2047, (1 << 16) + 5])
@pytest.mark.parametrize("off", [0, 1])
def test_packed_kernel_ignores_bits_past_d(cuda, d, off):
    """D % 32 != 0: the bits of the last word past D are set, and neither
    the kernel (four words a load at D = 1000 and 2047, one at 33 and
    65,541) nor the plain version reads them."""
    v, pi = _dense_case(7, d, 0.05, seed=d + off)
    words = kpk.pack_bits(v)
    used = d - 32 * (words.shape[1] - 1)
    junk = (0xFFFFFFFF << used) & 0xFFFFFFFF
    words[:, -1] |= junk - (1 << 32) if junk >= 1 << 31 else junk
    k = min(d, 300)
    for pack_b in (None, 4):
        want = kd.cminhash_dense_plain(v, pi, k, shift_offset=off,
                                       pack_b=pack_b)
        assert torch.equal(kpk.cminhash_packed_plain(
            words, pi, k, shift_offset=off, pack_b=pack_b), want)
        got = kpk.cminhash_packed_kernel(words.to(cuda), pi.to(cuda), k,
                                         shift_offset=off, pack_b=pack_b)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


# (D, K) where each placement is offered: the pair table only at K > 64,
# the uint16 table only at D <= 65,536, global everywhere
_PLACEMENTS = {"uint16 shared": 0, "int32 global": 1, "uint16 pairs": 2}


@pytest.mark.parametrize("placement", list(_PLACEMENTS))
@pytest.mark.parametrize("d,k", [(2048, 64), (2048, 512), (3000, 1100),
                                 (1 << 16, 256), ((1 << 16) + 1, 100)])
def test_each_forced_placement_matches_plain(cuda, placement, d, k):
    """Each table placement forced through the kernels' test entry point
    (the per-call choice takes only one per shape): equal to the plain
    version where it is offered, a refused launch where it is not."""
    v, pi = _dense_case(5, d, 0.03, seed=d + k)
    p = _PLACEMENTS[placement]
    offered = {0: d <= 1 << 16, 1: True,
               2: k > 64 and d <= _pair_limit(k, 1)}[p]
    hooks = [m.KERNEL.entry("force_placement", [ctypes.c_int])
             for m in (ks, kd, kpk)]
    try:
        for hook in hooks:
            hook(p)
        if offered:
            _signing_kernels(v, pi, k, cuda, pack_b=8)
        else:
            with pytest.raises(RuntimeError, match="launch failed"):
                kd.cminhash_dense_kernel(v.to(cuda), pi.to(cuda), k)
            with pytest.raises(RuntimeError, match="launch failed"):
                kpk.cminhash_packed_kernel(kpk.pack_bits(v).to(cuda),
                                           pi.to(cuda), k)
            with pytest.raises(RuntimeError, match="launch failed"):
                ks.cminhash_sparse_kernel(
                    torch.zeros((5, 1), dtype=torch.int32, device=cuda),
                    pi.to(cuda), k)
    finally:
        for hook in hooks:
            hook(-1)


@pytest.mark.parametrize("q,nb,r", [(1, 1, 1), (1088, 32, 8), (7, 5, 13)])
@pytest.mark.parametrize("sign_extend", [False, True])
def test_fold_kernel_matches_plain_and_host(cuda, q, nb, r, sign_extend):
    gen = torch.Generator().manual_seed(q + r)
    rows = torch.randint(-2**31, 2**31 - 1, (q, nb, r), generator=gen,
                         dtype=torch.int32)
    want = kq.fold_rows_plain(rows, sign_extend=sign_extend)
    got = kq.fold_rows_kernel(rows.to(cuda), sign_extend=sign_extend)
    assert torch.equal(got.cpu(), want)
    if sign_extend:
        host = band_hashes(rows.reshape(q, nb * r).numpy(), nb, r)
        assert np.array_equal(kq.hashes_to_host(got), host)


@pytest.mark.parametrize("ns,w,mp,nb", [(37, 3, 5, 5), (64, 2, 4, 4),
                                        (101, 7, 16, 8), (16, 1, 2, 3),
                                        (2048, 8, 16, 32)])
def test_probe_kernel_matches_plain_and_host_walk(cuda, ns, w, mp, nb):
    rng = np.random.default_rng(ns)
    sigs = rng.integers(0, 40, (260, nb * 4), dtype=np.int32)
    hashes = band_hashes(sigs, nb, 4)
    hashes[5, 0] = kp.SENTINEL_KEY
    table = BandedLSHTable(nb, n_slots=ns, bucket_width=w, max_probes=mp,
                           device=cuda)
    table.insert(hashes, np.arange(260))
    qh = hashes[:70].copy()
    qh[3, 1] = kp.SENTINEL_KEY
    qh[60:] = rng.integers(0, 1 << 60, (10, nb)).astype(np.uint64)
    h = torch.from_numpy(qh.view(np.int64))
    flat = torch.tensor(table.records.reshape(-1, 2 + w))
    want = kp.lsh_probe_plain(flat, torch.tensor(kp.probe_operands(qh, ns)),
                              n_slots=ns, max_probes=mp)
    got = kp.lsh_probe_hashes_kernel(flat.to(cuda), h.to(cuda), n_slots=ns,
                                     max_probes=mp)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(table.lookup(qh, impl="device"),
                          table.lookup(qh, impl="numpy"))


@pytest.mark.parametrize("r", [4, 12, 20])
@pytest.mark.parametrize("sign_extend", [False, True])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_fold_kernel_vector_and_scalar_rows(cuda, r, sign_extend, offset):
    """Rows of whole 16-byte vectors (R % 4 == 0), past one batch of
    vector loads (R = 20), and rows that a storage offset moves off the
    16-byte boundary (read as scalars)."""
    gen = torch.Generator().manual_seed(r + offset)
    q, nb = 33, 7
    buf = torch.randint(-2**31, 2**31 - 1, (q * nb * r + offset,),
                        generator=gen, dtype=torch.int32)
    rows = buf[offset:].view(q, nb, r)
    want = kq.fold_rows_plain(rows, sign_extend=sign_extend)
    got = kq.fold_rows_kernel(buf.to(cuda)[offset:].view(q, nb, r),
                              sign_extend=sign_extend)
    assert torch.equal(got.cpu(), want)


# -- the probe from device hashes and from words ------------------------------

def _full_range_table(ns, w, mp, load, nb=3, seed=0, device="cpu"):
    """The port's table loaded to ``load`` of its slots with full-range
    uint64 hashes (about half >= 2^63), duplicate keys and a sentinel;
    queries: stored keys, absent keys, the sentinel, keys >= 2^63."""
    rng = np.random.default_rng(seed + ns + w + mp)
    n = max(8, int(load * ns))
    hashes = rng.integers(0, 2**64, (n, nb), dtype=np.uint64)
    hashes[n // 2: n // 2 + n // 8] = hashes[: n // 8]
    hashes[3, 1] = kp.SENTINEL_KEY
    table = BandedLSHTable(nb, n_slots=ns, bucket_width=w, max_probes=mp,
                           device=device)
    table.insert(hashes, np.arange(n))
    absent = rng.integers(0, 2**64, (12, nb), dtype=np.uint64)
    absent[0, 0] = kp.SENTINEL_KEY
    absent[1] = 2**63 + np.arange(nb, dtype=np.uint64)
    return table, np.ascontiguousarray(np.concatenate([hashes, absent]))


# (n_slots, W, max_probes, load): pow2 and not; W even and odd, at and past
# the widths whose ids the fused walk holds (16 even, 8 odd); max_probes 1
# and 16; nearly full tables (chains past four steps, wrapping)
PROBE_SWEEP = [(2048, 8, 16, 0.93), (3001, 8, 16, 0.93), (2048, 3, 16, 0.6),
               (3001, 5, 16, 0.95), (2048, 8, 1, 0.5), (3001, 1, 1, 0.3),
               (2048, 16, 16, 0.9), (3001, 18, 16, 0.9), (1021, 7, 16, 0.95),
               (1024, 9, 16, 0.9)]


@pytest.mark.parametrize("ns,w,mp,load", PROBE_SWEEP)
def test_probe_kernel_from_hashes_matches_plain(cuda, ns, w, mp, load):
    table, qh = _full_range_table(ns, w, mp, load, device=cuda)
    flat = torch.tensor(table.records.reshape(-1, 2 + w))
    h = torch.from_numpy(qh.view(np.int64))
    want = kp.lsh_probe_hashes_plain(flat, h, n_slots=ns, max_probes=mp)
    got = kp.lsh_probe_hashes_kernel(flat.to(cuda), h.to(cuda), n_slots=ns,
                                     max_probes=mp)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert (want >= 0).any()
    assert np.array_equal(table.lookup(qh, impl="device"),
                          table.lookup(qh, impl="numpy"))


@pytest.mark.parametrize("ns,w,mp,r", [(2048, 8, 16, 2), (3001, 8, 16, 8),
                                       (1021, 3, 16, 3), (2048, 18, 1, 8),
                                       (4096, 7, 16, 20)])
@pytest.mark.parametrize("offset", [0, 1])
def test_probe_kernel_from_words_matches_plain(cuda, ns, w, mp, r, offset):
    """Fold + probe in one launch: R = 8 (16-byte rows), R not a multiple of
    4, R past one batch of vector loads, rows moved off the 16-byte
    boundary by a storage offset."""
    rng = np.random.default_rng(ns + r + offset)
    nb = 4
    words = rng.integers(0, 2**32, (int(0.8 * ns), nb * r), dtype=np.uint32)
    words[len(words) // 2:][: len(words) // 4] = words[: len(words) // 4]
    table = BandedLSHTable(nb, n_slots=ns, bucket_width=w, max_probes=mp,
                           device="cpu")
    table.insert(band_hashes_packed(words, nb), np.arange(len(words)))
    q = np.concatenate([words[::3], rng.integers(
        0, 2**32, (9, nb * r), dtype=np.uint32)])
    buf = torch.zeros(q.size + offset, dtype=torch.int32)
    buf[offset:] = torch.from_numpy(q.view(np.int32).reshape(-1))
    rows = buf[offset:].view(len(q), nb, r)
    flat = torch.tensor(table.records.reshape(-1, 2 + w))
    want = kq.fold_probe_plain(flat, rows, n_slots=ns, max_probes=mp)
    got = kq.fold_probe_kernel(flat.to(cuda),
                               buf.to(cuda)[offset:].view(len(q), nb, r),
                               n_slots=ns, max_probes=mp)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert (want >= 0).any() and (want < 0).all(dim=1).any()


def _keys_with_base(base: np.ndarray, ns: int, rng) -> np.ndarray:
    """uint64 keys with ``key mod ns == base``, every other one >= 2^63."""
    top = rng.integers(0, 2**32, len(base), dtype=np.uint64)
    top[::2] |= np.uint64(1 << 31)
    key = top * np.uint64(2**32)
    key = key + (base + np.uint64(ns) - key % np.uint64(ns)) % np.uint64(ns)
    assert (key % np.uint64(ns) == base).all()
    return key


def _plant(rec, row, key, ids) -> None:
    rec[row, :2] = torch.from_numpy(np.array([key], np.uint64)
                                    .view(np.int32)).to(rec.device)
    rec[row, 2:] = ids


def _planted(ns, w, mp, nb, rng, full):
    """Records of ``nb`` bands that are full (every slot holds another key:
    walks run to ``max_probes``) or empty (every slot unused), and queries
    whose keys sit in the last band at each probe step t < max_probes, half
    of them with a base slot in the last 7 slots (their four-step spans
    cross the table's end).  Returns the records, the queries and the
    (query, row) of each planted key that no later one overwrote."""
    rows = nb * ns
    if full:
        rec = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (rows, 2 + w),
                                            dtype=np.int64).astype(np.int32))
        rec[(rec[:, 0] == -1) & (rec[:, 1] == -1), 0] = 0
    else:
        rec = torch.full((rows, 2 + w), -1, dtype=torch.int32)
    n_q = 4 * mp
    base = rng.integers(0, ns, n_q).astype(np.uint64)
    base[::2] = np.uint64(ns - 1) - np.arange(0, n_q, 2, dtype=np.uint64) % 7
    key = _keys_with_base(base, ns, rng)
    qh = rng.integers(0, 2**64, (n_q, nb), dtype=np.uint64)
    qh[:, nb - 1] = key
    owner = {}
    if full:
        for i in range(n_q):
            t = i % mp
            row = (nb - 1) * ns + (int(base[i]) + t * (t + 1) // 2) % ns
            _plant(rec, row, key[i], torch.arange(w, dtype=torch.int32)
                   + 1000 * i)
            owner[row] = i
    return rec, np.ascontiguousarray(qh), [(i, r) for r, i in owner.items()]


@pytest.mark.parametrize("ns,w", [(3001, 8), (2048, 8), (61, 3), (64, 18),
                                  (1000, 7)])
@pytest.mark.parametrize("full", [True, False])
def test_probe_kernel_full_empty_and_wrapping_tables(cuda, ns, w, full):
    rng = np.random.default_rng(ns + w + int(full))
    mp, nb = 16, 2
    rec, qh, planted = _planted(ns, w, mp, nb, rng, full)
    h = torch.from_numpy(qh.view(np.int64))
    want = kp.lsh_probe_hashes_plain(rec, h, n_slots=ns, max_probes=mp)
    got = kp.lsh_probe_hashes_kernel(rec.to(cuda), h.to(cuda), n_slots=ns,
                                     max_probes=mp)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if full:           # every planted key found, at whichever step it sits
        assert len(planted) > mp
        for i, row in planted:
            assert torch.equal(want[i * nb + nb - 1], rec[row, 2:])
    else:
        assert (want == -1).all()


def test_probe_kernels_on_no_entries(cuda):
    rec = torch.full((3 * 64, 10), -1, dtype=torch.int32, device=cuda)
    got = kp.lsh_probe_hashes_kernel(
        rec, torch.zeros((0, 3), dtype=torch.int64, device=cuda), n_slots=64,
        max_probes=16)
    assert got.shape == (0, 8)
    got = kq.fold_probe_kernel(
        rec, torch.zeros((0, 3, 8), dtype=torch.int32, device=cuda),
        n_slots=64, max_probes=16)
    assert got.shape == (0, 8)


def test_probe_kernel_record_offsets_past_2_31(cuda):
    """Records of more than 2^31 int32 elements (~8.6 GB, built on the
    card): keys at probe steps 0-4 from base slots in the band's last 12
    (the slots whose offsets need 64 bits), with their chains' earlier
    slots taken by other keys, and spans that wrap from there to the
    band's start."""
    ns, w, nb, mp = (1 << 27) + 5, 6, 2, 16
    rec = torch.full((nb * ns, 2 + w), -1, dtype=torch.int32, device=cuda)
    assert rec.numel() > 2**31
    rng = np.random.default_rng(5)
    n_q = 40
    base = np.uint64(ns - 1) - np.arange(n_q, dtype=np.uint64) % 12
    key = _keys_with_base(base, ns, rng)
    qh = rng.integers(0, 2**64, (n_q, nb), dtype=np.uint64)
    qh[:, 1] = key
    owner = {}
    for i in range(0, n_q, 2):                  # odd queries stay absent
        t = i % 5
        chain = [ns + (int(base[i]) + s * (s + 1) // 2) % ns
                 for s in range(t + 1)]
        for row in chain[:-1]:                  # the chain's earlier slots
            if int(rec[row, 0]) == -1 and int(rec[row, 1]) == -1:
                _plant(rec, row, int(rng.integers(0, 2**62)),
                       torch.full((w,), -7, dtype=torch.int32))
                owner[row] = -1
        _plant(rec, chain[-1], key[i], torch.arange(w, dtype=torch.int32)
               + 100 * i)
        owner[chain[-1]] = i
    h = torch.from_numpy(qh.view(np.int64)).to(cuda)
    want = kp.lsh_probe_hashes_plain(rec, h, n_slots=ns, max_probes=mp)
    got = kp.lsh_probe_hashes_kernel(rec, h, n_slots=ns, max_probes=mp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    found = [(row, i) for row, i in owner.items() if i >= 0]
    assert any(row * (2 + w) >= 2**31 for row, _ in found)
    for row, i in found:
        assert torch.equal(want[i * nb + 1].cpu(),
                           torch.arange(w, dtype=torch.int32) + 100 * i)
    assert (want[1::nb][1::2] == -1).all()
    del rec, want, got
    torch.cuda.empty_cache()


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rec = torch.full((3 * 64, 10), -1, dtype=torch.int32, device=cuda)
    h = torch.zeros((5, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        kp.lsh_probe_hashes_kernel(rec, h.int(), n_slots=64, max_probes=4)
    with pytest.raises(ValueError, match="are not"):
        kp.lsh_probe_hashes_kernel(rec, h, n_slots=32, max_probes=4)
    with pytest.raises(ValueError, match="are not"):
        kp.lsh_probe_hashes_kernel(rec[:0], h, n_slots=0, max_probes=4)
    with pytest.raises(ValueError, match="cuda|cpu"):
        kp.lsh_probe_hashes_kernel(rec.cpu(), h, n_slots=64, max_probes=4)
    with pytest.raises(ValueError, match="contiguous"):
        kq.fold_probe_kernel(rec, torch.zeros(
            (5, 8, 3), dtype=torch.int32, device=cuda).transpose(1, 2),
            n_slots=64, max_probes=4)


@pytest.mark.parametrize("q,n,k", [(1, 1, 1), (37, 1001, 130),
                                   (64, 16384, 256), (65, 63, 31),
                                   (1, 300, 33), (300, 1, 33),
                                   (63, 127, 33), (64, 128, 64),
                                   (129, 257, 33), (127, 255, 257)])
def test_collision_kernel_matches_plain(cuda, q, n, k):
    """Ragged Q and N on both sides of the 64 x 128 tile, K on both sides
    of the 32-word chunk (16-byte copies where K % 4 == 0, 4-byte ones
    otherwise)."""
    gen = torch.Generator().manual_seed(q * n + k)
    a = torch.randint(0, 4, (q, k), generator=gen, dtype=torch.int32)
    b = torch.randint(0, 4, (n, k), generator=gen, dtype=torch.int32)
    want = kc.collision_counts_plain(a, b)
    got = kc.collision_counts_kernel(a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), want)


def _words(rows, k, b, gen):
    """(rows, W) words of K b-bit codes drawn from three values, so about a
    third of the codes match."""
    return pack_codes(torch.randint(0, 3, (rows, k), generator=gen,
                                    dtype=torch.int32), b)


def _set_bits_past_k(words, k, b):
    """The same words with every bit of the last word past code K set: on
    both sides of a pair those codes are equal, and must not count."""
    cpw = 32 // b
    if k % cpw == 0:
        return words
    junk = (0xFFFFFFFF << (k % cpw) * b) & 0xFFFFFFFF
    out = words.clone()
    out[:, -1] |= junk - (1 << 32) if junk >= 1 << 31 else junk
    return out


@pytest.mark.parametrize("b", PACK_BITS)
@pytest.mark.parametrize("k", [1, 31, 33, 64, 257])
@pytest.mark.parametrize("q,n", [(37, 300), (65, 129)])
def test_packed_collision_kernel_matches_unpack_and_plain(cuda, b, k, q, n):
    """Every pack width, K a multiple of 32/b or not: the codes past K in
    the last word count neither as zeros nor as set bits."""
    gen = torch.Generator().manual_seed(b * 1000 + k + q)
    wq, wn = _words(q, k, b, gen), _words(n, k, b, gen)
    wn[3] = wq[1]                                 # a row that matches fully
    want = kc.packed_collision_counts_plain(wq, wn, k, b)
    assert int(want[1, 3]) == k
    for a, c in ((wq, wn), (_set_bits_past_k(wq, k, b),
                            _set_bits_past_k(wn, k, b))):
        got = kc.packed_collision_counts_kernel(a.to(cuda), c.to(cuda), k, b)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        got = ops.packed_collision_counts(a.to(cuda), c.to(cuda), k, b)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k", [33, 256])
def test_collision_kernel_negative_and_sentinel_codes(cuda, k):
    """int32 codes across the sign bit, 2^31-1 (an empty row's code) and
    -2^31 on both sides: equality of the bits, nothing else."""
    gen = torch.Generator().manual_seed(k)
    pool = torch.tensor([-2 ** 31, -7, -1, 0, 1, 2 ** 31 - 1],
                        dtype=torch.int32)
    a = pool[torch.randint(0, 6, (70, k), generator=gen)]
    b = pool[torch.randint(0, 6, (200, k), generator=gen)]
    b[5] = a[0]
    want = kc.collision_counts_plain(a, b)
    got = kc.collision_counts_kernel(a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b", [32, 8])
def test_packed_collision_counts_whole_index_in_one_launch(cuda, b):
    """The serving fallback's shape: 64 query rows against a 262,144-row
    index in one launch, equal to the blocked unpack + plain count of
    16,384 rows at a time (the CPU path's blocks)."""
    q, n, k = 64, 262_144, 256
    gen = torch.Generator(device=cuda).manual_seed(b)
    wq = torch.randint(-2 ** 31, 2 ** 31 - 1, (q, pack_geometry(k, b)[1]),
                       generator=gen, device=cuda, dtype=torch.int32)
    wn = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, wq.shape[1]),
                       generator=gen, device=cuda, dtype=torch.int32)
    wn[::4096] = wq[0]
    wn[1::4096, : wq.shape[1] // 2] = wq[1, : wq.shape[1] // 2]
    before = kc.KERNEL.launches
    got = ops.packed_collision_counts(wq, wn, k, b)
    assert kc.KERNEL.launches == before + 1
    want = torch.cat([kc.packed_collision_counts_plain(
        wq, wn[lo: lo + 16384], k, b) for lo in range(0, n, 16384)], dim=1)
    assert torch.equal(got, want)
    assert int(got[0, 0]) == k and int(got[1, 1]) >= k // 2


def test_collision_output_past_2_31_entries(cuda):
    """Q * N > 2^31 counts at K = 4: the last rows and columns sit past an
    int32 offset."""
    q, n, k = 65_536, 32_769, 4
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(0, 2, (q, k), generator=gen, device=cuda,
                      dtype=torch.int32)
    b = torch.randint(0, 2, (n, k), generator=gen, device=cuda,
                      dtype=torch.int32)
    got = kc.collision_counts_kernel(a, b)
    assert q * n > 2 ** 31
    rows = torch.tensor([0, 31_000, q - 2, q - 1], device=cuda)
    want = kc.collision_counts_plain(a[rows].cpu(), b.cpu())
    assert torch.equal(got[rows].cpu(), want)
    want = kc.collision_counts_plain(a.cpu(), b[-3:].cpu())
    assert torch.equal(got[:, -3:].cpu(), want)
    del got


def test_collision_count_past_2_24_codes(cuda):
    """K = 2^24 + 40 with rows that match in every code: the count passes
    2^24, where a float count would lose its ones, so the kernel counts in
    segments of 2^24 codes."""
    k = (1 << 24) + 40
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(0, 2, (2, k), generator=gen, dtype=torch.int32)
    b = torch.randint(0, 2, (3, k), generator=gen, dtype=torch.int32)
    b[0] = a[0]
    b[2, :k - 5] = a[1, :k - 5]
    want = kc.collision_counts_plain(a, b)
    assert int(want[0, 0]) == k
    got = kc.collision_counts_kernel(a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kc.collision_counts_kernel(a.long(), a.long())
    with pytest.raises(ValueError, match="contiguous"):
        kc.collision_counts_kernel(a.t(), a.t())
    with pytest.raises(ValueError, match="cuda|cpu"):
        kc.collision_counts_kernel(a, a.cpu())
    with pytest.raises(ValueError, match=r"\(rows, 1\)"):
        kc.packed_collision_counts_kernel(a, a, 8, 4)
    pi = torch.arange(64, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ks.cminhash_sparse_kernel(a.long(), pi, 8)


def test_service_answers_the_same_on_card_and_cpu(cuda):
    from repro_torch.data.shingle import batch_shingles
    from repro_torch.data.synthetic import corpus_with_duplicates
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    docs, _ = corpus_with_duplicates(600, vocab=3000, doc_len=64, seed=0)
    idx = batch_shingles(docs, n=3, d=1 << 12, max_nnz=64)
    answers = []
    for device in ("cuda", "cpu"):
        svc = SimilaritySearchService(SearchConfig(
            d=1 << 12, k=64, n_bands=16, rows_per_band=4, n_shards=3,
            bucket_width=1, device=device))
        with svc.pipeline(depth=2) as pipe:
            for lo in range(0, 500, 100):
                pipe.submit(idx[lo: lo + 100])
        answers.append(svc.query_sparse(idx[450:], top_k=5))
    assert np.array_equal(answers[0][0], answers[1][0])
    assert np.array_equal(answers[0][1], answers[1][1])
