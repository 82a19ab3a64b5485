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
holds, set bits past D in the last word; for the selective scan, the LM
cell's widths, S of 0 and below a tile, ragged and unaligned channels,
every lane split, and its dispatch from ``ssm_block`` and a prefill with
no host sync.  Integer outputs: tolerance 0; the scan's float32: 1e-5 of
the largest value.
Also: the wrappers refuse what the kernels do not take, the service and
the raw-signature store answer the same on the card as on the CPU, and
snapshots cross between the card and the CPU.  Imports neither jax nor repro,
so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.core.lsh import band_hashes, band_hashes_packed
from repro_torch.kernels import cminhash_kernel as kd
from repro_torch.kernels import cminhash_packed as kpk
from repro_torch.kernels import cminhash_sparse as ks
from repro_torch.kernels import collision_kernel as kc
from repro_torch.kernels import dispatch
from repro_torch.kernels import lsh_probe as kp
from repro_torch.kernels import ops
from repro_torch.kernels import query_fused as kq
from repro_torch.kernels import ssm_scan as kss
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


def _signing_kernels(v, pi, k, cuda, placement=None, **kw):
    """The dense int8, bit-packed and sparse kernels on the same rows, each
    against the dense plain version (``placement``: the kernels' launch
    argument)."""
    want = kd.cminhash_dense_plain(v, pi, k, **kw)
    got = kd.cminhash_dense_kernel(v.to(cuda), pi.to(cuda), k,
                                   placement=placement, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    got = kpk.cminhash_packed_kernel(kpk.pack_bits(v).to(cuda), pi.to(cuda),
                                     k, placement=placement, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    nnz = max(int((v > 0).sum(1).max()), 1)
    idx = torch.full((v.shape[0], nnz), -1, dtype=torch.int32)
    for r in range(v.shape[0]):
        pos = torch.nonzero(v[r] > 0).flatten().to(torch.int32)
        idx[r, :len(pos)] = pos
    assert torch.equal(ks.cminhash_sparse_plain(idx, pi, k, **kw), want)
    got = ks.cminhash_sparse_kernel(idx.to(cuda), pi.to(cuda), k,
                                    placement=placement, **kw)
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
    """The words-in leg, the fold kernel and then the probe from its hashes,
    against the plain fold and probe: R = 8 (16-byte rows), R not a
    multiple of 4, R past one batch of vector loads, rows moved off the
    16-byte boundary by a storage offset."""
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
    want = kp.lsh_probe_hashes_plain(flat, kq.fold_rows_plain(rows),
                                     n_slots=ns, max_probes=mp)
    got = kp.lsh_probe_hashes_kernel(
        flat.to(cuda), kq.fold_rows_kernel(
            buf.to(cuda)[offset:].view(len(q), nb, r)),
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
        kp.lsh_probe_hashes_kernel(rec, torch.zeros(
            (3, 5), dtype=torch.int64, device=cuda).t(), n_slots=64,
            max_probes=4)


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


@pytest.mark.parametrize("kw", [
    dict(),                                    # DedupConfig's defaults
    dict(d=1 << 12, k=100, n_bands=25, rows_per_band=4, threshold=0.7)])
def test_dedup_on_the_card_equals_the_cpu(cuda, kw):
    """dedup_corpus on the card (one sparse-signing launch, the pair
    verification's gather and count there) against the CPU run, every
    field, with the same permutations."""
    import dataclasses

    from repro_torch.data.dedup import DedupConfig, dedup_corpus
    from repro_torch.data.synthetic import corpus_with_duplicates
    from repro_torch.kernels import all_kernels
    docs, _ = corpus_with_duplicates(3000, vocab=30_000, doc_len=128,
                                     dup_fraction=0.4, seed=2)
    cfg = DedupConfig(**kw)
    gen = torch.Generator().manual_seed(7)
    params = (torch.randperm(cfg.d, generator=gen),
              torch.randperm(cfg.d, generator=gen))
    sparse = all_kernels()["cminhash_sparse"]
    before = sparse.launches
    card = dedup_corpus(docs, cfg, device="cuda", params=params)
    assert sparse.launches == before + 1
    cpu = dedup_corpus(docs, cfg, device="cpu", params=params)
    assert card.n_verified > 0
    for f in dataclasses.fields(card):
        a, b = getattr(card, f.name), getattr(cpu, f.name)
        assert type(a) is type(b)
        assert np.array_equal(a, b), f.name


@pytest.mark.parametrize("b", [1, 8])
def test_fit_logistic_on_the_card_against_the_cpu(cuda, b):
    """The trainer on the card against the CPU within the CPU tests'
    tolerances (tests/test_torch_linear.py): 300 steps, w within 1e-3,
    probabilities within 1e-3, equal accuracy."""
    from repro_torch.core.linear_model import (HashedLinearConfig, accuracy,
                                               fit_logistic,
                                               predict_logistic)
    rng = np.random.default_rng(b)
    sigs = torch.from_numpy(rng.integers(0, 1 << 20, (1024, 512))
                            .astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 2, 1024).astype(np.int32))
    sigs[y == 1, :256] = 7                     # a learnable signal
    cfg = HashedLinearConfig(b=b)
    wc, bc = fit_logistic(sigs.to(cuda), y.to(cuda), cfg)
    assert wc.is_cuda and bc.is_cuda
    w, bias = fit_logistic(sigs, y, cfg)
    assert (wc.cpu() - w).abs().max() <= 1e-3
    assert abs(float(bc) - float(bias)) <= 1e-3
    pc = predict_logistic((wc, bc), sigs.to(cuda), b).cpu()
    p = predict_logistic((w, bias), sigs, b)
    assert (pc - p).abs().max() <= 1e-3
    assert accuracy((wc, bc), sigs.to(cuda), y.to(cuda), b) == \
        accuracy((w, bias), sigs, y, b)


def _raw_corpus(n=600, k=64, seed=3):
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 1 << 16, (n, k), dtype=np.int32)
    sigs[n // 2: n // 2 + 40] = sigs[:40]         # duplicates
    strangers = rng.integers(1 << 20, 1 << 24, (6, k), dtype=np.int32)
    return sigs, np.concatenate([sigs[:50], strangers])


@pytest.mark.parametrize("b,s,bw", [(2, 1, 8), (1, 3, 1), (32, 2, 1)])
def test_raw_store_answers_the_same_on_card_and_cpu(cuda, b, s, bw):
    """The raw-signature path on the card (probe kernel from host keys,
    collision kernel for scoring and the fallback) against the same store
    on the CPU: the single store and the sharded plane."""
    from repro_torch.store import ShardedSketchStore, SketchStore, StoreConfig
    sigs, q = _raw_corpus()
    cfg = StoreConfig(k=64, n_bands=16, rows_per_band=4, b=b,
                      bucket_width=bw, n_slots=64)
    answers = []
    for device in ("cuda", "cpu"):
        single = SketchStore(cfg, device=device)
        plane = ShardedSketchStore(cfg, s, device=device)
        for lo in range(0, len(sigs), 150):
            single.add(sigs[lo: lo + 150])
            plane.add(sigs[lo: lo + 150])
        answers.append((single.query(q, top_k=5), plane.query(q, top_k=5),
                        single.digest(), plane.last_timings["n_fallback"]))
    (a1, a2, ad, afb), (c1, c2, cd, cfb) = answers
    for got, want in ((a1, c1), (a2, c2), (a2, c1)):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    assert ad == cd and afb == cfb > 0


@pytest.mark.parametrize("b", [2, 32])
def test_snapshots_cross_between_card_and_cpu(cuda, b, tmp_path):
    """A plane saved from the card loads on the CPU, and the reverse; each
    answers as the store it was saved from, with equal digests."""
    from repro_torch.store import ShardedSketchStore, StoreConfig
    sigs, q = _raw_corpus(seed=b)
    cfg = StoreConfig(k=64, n_bands=16, rows_per_band=4, b=b)
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        live = ShardedSketchStore(cfg, 3, device=src)
        live.add(sigs)
        path = str(tmp_path / f"{src}_to_{dst}")
        live.save(path)
        back = ShardedSketchStore.load(path, device=dst)
        assert back.device.type == dst
        for got, want in zip(back.query(q, top_k=5), live.query(q, top_k=5)):
            assert np.array_equal(got, want)
        for a, c in zip(back.shards, live.shards):
            assert a.store.digest() == c.store.digest()


# -- the tcp shard plane on the card -----------------------------------------

def _tcp_corpus(seed=5):
    from repro_torch.data.shingle import batch_shingles
    from repro_torch.data.synthetic import corpus_with_duplicates
    docs, _ = corpus_with_duplicates(600, vocab=3000, doc_len=64,
                                     seed=seed)
    idx = batch_shingles(docs, n=3, d=1 << 12, max_nnz=64)
    fresh = np.sort(np.random.default_rng(seed).integers(
        0, 1 << 12, (8, 64), np.int32), axis=1)
    return idx, np.concatenate([idx[450:], fresh])


def test_tcp_plane_on_the_card_answers_like_the_inproc_card_plane(
        cuda, monkeypatch):
    """Two shard workers on the card (spilled keys, fallback rows) answer
    as the in-process card plane; the coordinator copies a batch's hashes
    and words to the host once each, folds once, and launches no probe or
    collision kernel; each worker probes from the wire's hashes and scores
    its fallback rows on the card, and launches no fold."""
    import json as _json
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    idx, q = _tcp_corpus()
    common = dict(d=1 << 12, k=64, n_bands=16, rows_per_band=4, n_shards=2,
                  bucket_width=1, device="cuda")
    inproc = SimilaritySearchService(SearchConfig(**common))
    with SimilaritySearchService(SearchConfig(transport="tcp", **common),
                                 params=(inproc.engine.sigma,
                                         inproc.engine.pi)) as tcp:
        for svc in (inproc, tcp):
            with svc.pipeline(depth=2) as pipe:
                for lo in range(0, 450, 90):
                    pipe.submit(idx[lo: lo + 90])
        want = inproc.query_sparse(q, top_k=5)
        fb = inproc.store.last_timings["n_fallback"]
        copies = {"hashes": 0, "words": 0}

        def count(key, fn):
            def wrapped(*a):
                copies[key] += 1
                return fn(*a)
            return wrapped
        monkeypatch.setattr(kq, "hashes_to_host",
                            count("hashes", kq.hashes_to_host))
        monkeypatch.setattr(kq, "u32_to_host", count("words", kq.u32_to_host))
        launches = {n: k.launches for n, k in (
            ("fold", kq.KERNEL), ("probe", kp.KERNEL), ("coll", kc.KERNEL))}
        for _ in range(2):
            got = tcp.query_sparse(q, top_k=5)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
        assert tcp.store.last_timings["n_fallback"] == fb > 0
        stats = [sh.stats() for sh in tcp.store.shards]
    assert copies == {"hashes": 2, "words": 2}
    assert {n: k.launches - launches[n] for n, k in (
        ("fold", kq.KERNEL), ("probe", kp.KERNEL), ("coll", kc.KERNEL))} \
        == {"fold": 2, "probe": 0, "coll": 0}
    assert sum(int(st["n_spilled"]) for st in stats) > 0
    for st in stats:
        assert st["device"].startswith("cuda") and st["probe_impl"] == "device"
        w = _json.loads(st["launches"])
        assert w["fold"] == 0
        assert w["lsh_probe"] == 2 and w["collision"] == 2
        counters = _json.loads(st["obs"])["counters"]
        assert counters["kernel.query_fused.cuda"] == 2
        assert not any(n.startswith("kernel.") and n.endswith(".plain")
                       for n in counters)


def test_tcp_worker_uploads_each_query_operand_once_on_the_card(
        cuda, monkeypatch):
    """A worker's QUERY on a card store: one upload of the hashes, one of
    the words, one probe launch from the uploaded hashes and no fold; the
    partial equals the CPU store's."""
    from repro_torch.store import SketchStore, StoreConfig
    from repro_torch.store import planner as t_planner
    from repro_torch.store import store as t_store
    from repro_torch.transport import server as t_server
    from repro_torch.transport import wire
    from repro_torch.transport.wire import Message, MsgType
    sigs, q = _raw_corpus(n=400)
    cfg = StoreConfig(k=64, n_bands=16, rows_per_band=4, bucket_width=1,
                      auto_rebuild=False)
    stores = {d: SketchStore(cfg, device=d) for d in ("cuda", "cpu")}
    for st in stores.values():
        st.add(sigs)
    lo, hi = wire.split_u64(band_hashes(q, 16, 4))
    qwords = pack_codes(torch.from_numpy(q), 32).numpy().view(np.uint32)
    calls = {"hashes": 0, "words": 0}

    def count(key, fn):
        def wrapped(*a):
            if key != "words" or isinstance(a[0], np.ndarray):
                calls[key] += 1                # words: a host -> device copy
            return fn(*a)
        return wrapped

    def refuse(*a, **kw):
        raise AssertionError("a worker folded")
    monkeypatch.setattr(t_store, "hashes_to_device",
                        count("hashes", t_store.hashes_to_device))
    monkeypatch.setattr(t_store, "as_device_words",
                        count("words", t_store.as_device_words))
    monkeypatch.setattr(dispatch, "fold_hashes", refuse)
    replies = {}
    for d, st in stores.items():
        probes, folds = kp.KERNEL.launches, kq.KERNEL.launches
        replies[d], _ = t_server._handle(st, Message(MsgType.QUERY, {
            "hash_lo": lo, "hash_hi": hi, "qwords": qwords, "top_k": 5,
            "mode": "sig"}))
        if d == "cuda":
            assert calls == {"hashes": 1, "words": 1}
            assert kp.KERNEL.launches == probes + 1
            assert kq.KERNEL.launches == folds
    assert stores["cuda"].n_spilled > 0
    assert wire.message_bytes(replies["cuda"]) == \
        wire.message_bytes(replies["cpu"])
    uploads, to_device = [], t_planner.as_device_words

    def counted(w, dev):
        if isinstance(w, np.ndarray):
            uploads.append(w.shape)
        return to_device(w, dev)
    monkeypatch.setattr(t_planner, "as_device_words", counted)
    collisions = kc.KERNEL.launches
    t_server._handle(stores["cuda"], Message(MsgType.BRUTE, {
        "qwords": qwords[-6:], "top_k": 3}))
    assert uploads == [(6, 64)] and kc.KERNEL.launches == collisions + 1


def test_tcp_worker_asked_for_cuda_without_a_visible_card_fails_at_spawn(
        cuda, monkeypatch):
    """With no card visible, a worker asked for ``cuda`` exits at boot and
    ``spawn_workers`` says so: it never serves from the CPU."""
    from repro_torch.store import StoreConfig
    from repro_torch.transport import spawn_workers
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="failed at boot"):
        spawn_workers(StoreConfig(k=64, n_bands=16, rows_per_band=4), 1,
                      device="cuda")


# -- the LM stack: the card against the port's CPU path ---------------------

def _lm_case(arch, monkeypatch, **changes):
    """A reduced float32 config (d_model 64), its weights drawn on the
    CPU and copied to the card, both bundles, and a seeded batch.  TF32 is
    off: the card's float32 products run in float32."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(reduced(get_config(arch), d_model=64),
                              dtype="float32", **changes)
    cpu = build(cfg, device="cpu")
    params = cpu.init(0)
    card_params = copy.deepcopy(params).cuda()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (2, 40))
             .astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patches"] = rng.normal(size=(2, 3, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "frames":
        batch["frames"] = rng.normal(size=(2, 40, cfg.d_model)).astype(
            np.float32)
    return cfg, cpu, params, build(cfg, device="cuda"), card_params, batch


def _lm_err(a: torch.Tensor, b: torch.Tensor) -> float:
    assert a.shape == b.shape and a.dtype == b.dtype
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def _lm_caches_close(card: dict, cpu: dict, tol: float):
    assert set(card) == set(cpu)
    for name in card:
        if name in ("t", "entry_pos"):
            assert torch.equal(card[name].cpu(), cpu[name])
        else:
            assert card[name].device.type == "cuda"
            assert _lm_err(card[name], cpu[name]) < tol, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_family_on_the_card_matches_the_cpu(cuda, monkeypatch, arch):
    """Each reduced arch in float32: forward logits, prefill logits and
    every cache tensor, 8 decode steps and greedy tokens on the card equal
    the CPU's within 1e-4 (sums run in other orders)."""
    from repro_torch.serve.decode import generate
    cfg, cpu, params, card, card_params, batch = _lm_case(arch, monkeypatch)
    assert _lm_err(card.forward(card_params, batch),
                   cpu.forward(params, batch)) < 1e-4
    s0 = 25
    pb = dict(batch, tokens=batch["tokens"][:, :s0])
    (gl, gc), (wl, wc) = (card.prefill(card_params, pb, max_len=40),
                          cpu.prefill(params, pb, max_len=40))
    assert _lm_err(gl, wl) < 1e-4
    _lm_caches_close(gc, wc, 1e-4)
    for t in range(s0, s0 + 8):
        tok = batch["tokens"][:, t]
        gl, gc = card.decode_step(card_params, gc, tok)
        wl, wc = cpu.decode_step(params, wc, tok)
        assert _lm_err(gl, wl) < 1e-4, t
    _lm_caches_close(gc, wc, 1e-4)
    assert np.array_equal(generate(card, card_params, pb, max_new_tokens=8),
                          generate(cpu, params, pb, max_new_tokens=8))


@pytest.mark.parametrize("arch,s0", [("h2o_danube3_4b", 25),
                                     ("h2o_danube3_4b", 16),
                                     ("hymba_1_5b", 30)])
def test_lm_ring_cache_on_the_card_matches_the_cpu(cuda, monkeypatch, arch,
                                                   s0):
    """Sliding window 16, prefill S >= C: the ring's slots, their
    positions and the decode past the wrap, card against CPU."""
    cfg, cpu, params, card, card_params, batch = _lm_case(
        arch, monkeypatch, sliding_window=16)
    pb = dict(batch, tokens=batch["tokens"][:, :s0])
    (gl, gc), (wl, wc) = (card.prefill(card_params, pb, max_len=40),
                          cpu.prefill(params, pb, max_len=40))
    assert gc["k"].shape[2] == 16
    assert _lm_err(gl, wl) < 1e-4
    _lm_caches_close(gc, wc, 1e-4)
    for t in range(s0, 40):
        tok = batch["tokens"][:, t]
        gl, gc = card.decode_step(card_params, gc, tok)
        wl, wc = cpu.decode_step(params, wc, tok)
        assert _lm_err(gl, wl) < 1e-4, t
        _lm_caches_close(gc, wc, 1e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_bf16_generate_on_the_card(cuda, arch):
    """The configs' own bf16 compute on the card: finite prefill logits,
    tokens in range, the same tokens twice, and no kernel of the port but
    the scan kernel, once a Mamba layer of each of the three prompts."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import all_kernels
    from repro_torch.models import build
    from repro_torch.serve.decode import generate
    cfg = reduced(get_config(arch))
    bundle = build(cfg, device="cuda")
    params = bundle.init(0)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (4, 16))
             .astype(np.int32)}
    if cfg.frontend == "patches":
        batch["patches"] = rng.normal(size=(4, 2, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "frames":
        batch["frames"] = rng.normal(size=(4, 16, cfg.d_model)).astype(
            np.float32)
    before = {n: k.launches for n, k in all_kernels().items()}
    logits, _ = bundle.prefill(params, batch)
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits)
                                                   .all())
    toks = generate(bundle, params, batch, max_new_tokens=6)
    assert toks.shape == (4, 6) and toks.min() >= 0 \
        and toks.max() < cfg.vocab_size
    assert np.array_equal(toks, generate(bundle, params, batch,
                                         max_new_tokens=6))
    n_ssm = sum("ssm" in cfg.mixer(i) for i in range(cfg.n_layers))
    before["ssm_scan"] += 3 * n_ssm
    assert {n: k.launches for n, k in all_kernels().items()} == before


# -- LM training: the card against the port's CPU path ------------------------

TRAIN_FAMILIES = ("llama3_2_1b", "qwen3_moe_30b_a3b", "falcon_mamba_7b",
                  "hymba_1_5b", "pixtral_12b", "seamless_m4t_medium")


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch, arch):
    """Two ``make_train_step`` steps (the second microbatched) of each
    family, reduced to d_model 64 in float32 with TF32 off: losses and grad
    norms within 1e-5 relative (sums in other orders), the parameters and
    moments after within 1e-4, a tenth of a step's move at lr 1e-3 (AdamW
    moves a parameter by about lr whatever its gradient's size, so a
    gradient near 0 that rounds differently moves it differently)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import make_train_step
    cfg, cpu, params, card, card_params, batch = _lm_case(arch, monkeypatch)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    states = [(params, init_opt_state(params)),
              (card_params, init_opt_state(card_params))]
    for n in (1, 2):
        step = [make_train_step(b, dataclasses.replace(tc, microbatches=n))
                for b in (cpu, card)]
        out = [s(p, o, batch) for s, (p, o) in zip(step, states)]
        states = [(p, o) for p, o, _ in out]
        (_, _, want), (_, _, got) = out
        for k in ("loss", "grad_norm", "lr"):
            assert got[k].device.type == "cuda"
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5)
    (wp, wo), (gp, go) = states
    for a, b in zip([*gp.parameters(), *go.mu.parameters(),
                     *go.nu.parameters()],
                    [*wp.parameters(), *wo.mu.parameters(),
                     *wo.nu.parameters()]):
        assert a.device.type == "cuda"
        assert _lm_err(a, b) < 1e-4
    assert int(go.step) == 2 and go.step.device.type == "cuda"


def test_lm_checkpoint_saved_on_the_card_restores_on_the_cpu(cuda, tmp_path):
    """A state trained on the card, saved, restored onto the CPU's tree and
    onto the card (``device=``): every leaf equal."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import make_train_step
    cfg = reduced(get_config("llama3_2_1b"))
    card = build(cfg, device="cuda")
    params = card.init(0)
    opt = init_opt_state(params)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size_real, (4, 32)).astype(np.int32)}
    params, opt, _ = make_train_step(card, TrainConfig())(params, opt, batch)
    state = {"params": params, "opt": opt}
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    host = build(cfg, device="cpu").init(1)
    target = {"params": host, "opt": init_opt_state(host)}
    _, on_cpu = ckpt.restore_checkpoint(str(tmp_path), target)
    _, on_card = ckpt.restore_checkpoint(str(tmp_path), target,
                                         device="cuda")
    want = ckpt._flatten(ckpt.host_tree(state))
    for got, dev in ((on_cpu, "cpu"), (on_card, "cuda")):
        assert next(got["params"].parameters()).device.type == dev
        assert got["opt"].step.device.type == dev
        flat = ckpt._flatten(ckpt.host_tree(got))
        assert [p for p, _ in flat] == [p for p, _ in want]
        for (path, a), (_, b) in zip(flat, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_lm_train_loop_restarts_on_the_card(cuda, tmp_path):
    """``TrainLoop`` on the card: stopped after 3 of 5 steps, restarted from
    its checkpoint, its losses and final parameters equal an uninterrupted
    run's exactly."""
    import itertools
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import TrainLoop
    cfg = reduced(get_config("llama3_2_1b"))
    bundle = build(cfg, device="cuda")
    tc = TrainConfig(total_steps=5, checkpoint_every=2, keep_checkpoints=1,
                     warmup_steps=1)
    batches = list(itertools.islice(token_batches(cfg.vocab_size_real, 4,
                                                  32, seed=2), 5))
    whole = TrainLoop(bundle, tc, iter(batches), str(tmp_path / "a"),
                      log=lambda *_: None).run()
    loop = TrainLoop(bundle, tc, iter(batches), str(tmp_path / "b"),
                     log=lambda *_: None)

    def stopping():
        for i, b in enumerate(batches):
            if i == 2:
                loop.stop()
            yield b
    loop.data = stopping()
    first = loop.run()
    assert ckpt.committed_steps(str(tmp_path / "b")) == [3]
    second = TrainLoop(bundle, tc, iter(batches[3:]), str(tmp_path / "b"),
                       log=lambda *_: None).run()
    assert first["losses"] + second["losses"] == whole["losses"]
    for a, b in zip(whole["params"].parameters(),
                    second["params"].parameters()):
        assert a.device.type == "cuda" and torch.equal(a, b)


# -- the mesh paths: two ranks sharing the card --------------------------------

@pytest.fixture(scope="module")
def card_pool():
    """Two gloo ranks on ``cuda:0`` (NCCL takes one rank a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.launch.ranks import RankPool
    pool = RankPool(2, device="cuda", timeout=300)
    try:
        yield pool
    finally:
        pool.close()


def _mesh_cfg(arch, **changes):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch), d_model=128),
                               dtype="float32", param_dtype="float32",
                               **changes)


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rank_collectives(x):
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import coordinate
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2, device="cuda")
    r = coordinate(mesh)["model"]
    before = col.counters()
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        t = torch.from_numpy(x).to("cuda", dt) * (r + 1)
        out[f"sum {dt}"] = col.all_reduce(t.clone(), mesh, "model").cpu()
    t = torch.from_numpy(x).cuda() * (r + 1)
    out["max"] = col.all_reduce(t.clone(), mesh, "model", "max").cpu()
    out["gather"] = col.all_gather(t, mesh, "model", 0).cpu()
    out["scatter"] = col.reduce_scatter(t, mesh, "model", 0).cpu()
    after = col.counters()
    return {"r": r, "out": {k: v.float().numpy() for k, v in out.items()},
            "counts": {k: v - before.get(k, 0) for k, v in after.items()}}


def test_mesh_collectives_on_the_card(card_pool):
    """The wrappers on CUDA tensors across two ranks of one card (gloo
    carries each kind there): right sums in float32, bf16 and int32, max,
    gather and scatter, each counted with its bytes."""
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    res = card_pool.run(_rank_collectives, x)
    for r in res:
        o = r["out"]
        for k in ("sum torch.float32", "sum torch.bfloat16",
                  "sum torch.int32"):
            assert np.array_equal(o[k], x * 3), k
        assert np.array_equal(o["max"], x * 2)
        assert np.array_equal(o["gather"], np.concatenate([x, x * 2]))
        assert np.array_equal(o["scatter"], (x * 3)[2 * r["r"]:
                                                    2 * r["r"] + 2])
        c = r["counts"]
        assert c["mesh.all_reduce.calls"] == 4
        assert c["mesh.all_gather.calls"] == 1
        assert c["mesh.reduce_scatter.calls"] == 1
        assert c["mesh.all_gather.bytes"] == x.nbytes


def _rank_step(arch, shape, mode, zero1, batch, want: dict, lr):
    """One mesh step of ``arch`` (reduced, float32) on the card, against
    the single-device step's parameters ``want``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import reference_path
    from repro_torch.distributed.sharding import stacked_shapes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.train.train_loop import (init_train_state,
                                              jit_train_step,
                                              train_state_shardings)
    _no_tf32()
    cfg = _mesh_cfg(arch, capacity_factor=64.0)
    bundle = build(cfg, device="cuda")
    mesh = make_host_mesh(*shape, device="cuda")
    tc = TrainConfig(warmup_steps=0, learning_rate=lr, sharding_mode=mode,
                     zero1=zero1)
    full = bundle.init(0)
    p_sh, _ = train_state_shardings(full, tc, mesh)
    shapes = stacked_shapes(full)
    params, opt = init_train_state(full, tc, mesh)
    params, opt, m = jit_train_step(bundle, tc, mesh)(params, opt, batch)
    err = 0.0
    for name, p in params.named_parameters():
        rel, i = reference_path(name)
        sl = p_sh[rel].slices(shapes[rel])
        w = torch.from_numpy(want[name])[sl if i is None else sl[1:]]
        assert p.device.type == "cuda"
        err = max(err, float((p.cpu() - w).abs().max()))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "err": err}


@pytest.mark.parametrize("arch,shape,mode,zero1", [
    ("llama3_2_1b", (1, 2), "tp", False),
    ("llama3_2_1b", (2, 1), "tp", True),
    ("llama3_2_1b", (2, 1), "fsdp", False),
    ("qwen3_moe_30b_a3b", (1, 2), "tp", False)])
def test_mesh_step_on_the_card_matches_one_device(card_pool, arch, shape,
                                                  mode, zero1):
    """Two ranks of one card, tensor parallel (the MoE expert parallel) or
    data parallel: loss and grad norm within 1e-5 relative of the same step
    on one device of the card, parameters within 1e-4 (lr 1e-3; float32,
    TF32 off)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import make_train_step
    _no_tf32()
    cfg = _mesh_cfg(arch, capacity_factor=64.0)
    bundle = build(cfg, device="cuda")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (4, 32))
             .astype(np.int32)}
    params = bundle.init(0)
    tc = TrainConfig(warmup_steps=0, learning_rate=1e-3)
    params, _, m = make_train_step(bundle, tc)(params, init_opt_state(params),
                                               batch)
    want = {n: p.cpu().numpy() for n, p in params.named_parameters()}
    res = card_pool.run(_rank_step, arch, shape, mode, zero1, batch, want,
                        1e-3)
    for r in res:
        if not (arch.startswith("qwen") and shape[0] > 1):
            assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
        assert r["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                               rel=1e-5)
        assert r["err"] < 1e-4


def _rank_moe_forward(batch, want):
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    _no_tf32()
    cfg = _mesh_cfg("qwen3_moe_30b_a3b", capacity_factor=64.0)
    bundle = build(cfg, device="cuda")
    mesh = make_host_mesh(1, 2, device="cuda")
    full = bundle.init(0)
    local = shard_tree(full, param_shardings(full, mesh))
    logits = bundle.forward(local, batch, mesh=mesh)
    return float((logits.cpu() - torch.from_numpy(want)).abs().max())


def test_mesh_moe_forward_on_the_card(card_pool):
    """Expert parallelism over two ranks of one card: the forward equals
    the single-device fallback within 1e-4."""
    from repro_torch.models import build
    _no_tf32()
    cfg = _mesh_cfg("qwen3_moe_30b_a3b", capacity_factor=64.0)
    bundle = build(cfg, device="cuda")
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (8, 32))
             .astype(np.int32)}
    want = bundle.forward(bundle.init(0), batch).cpu().numpy()
    assert all(e < 1e-4 for e in card_pool.run(_rank_moe_forward, batch,
                                                want))


def _rank_decode(batch, feed, want: list):
    """Prefill and teacher-forced decode over (1, 2) on the card, tp = 2,
    against one device's logits ``want``."""
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    _no_tf32()
    cfg = _mesh_cfg("llama3_2_1b")
    bundle = build(cfg, device="cuda")
    mesh = make_host_mesh(1, 2, device="cuda")
    full = bundle.init(0)
    local = shard_tree(full, param_shardings(full, mesh))
    logits, cache = bundle.prefill(local, batch, mesh=mesh, tp=2,
                                   max_len=batch["tokens"].shape[1]
                                   + len(feed))
    errs = [float((logits.cpu() - torch.from_numpy(want[0])).abs().max())]
    for tok, w in zip(feed, want[1:]):
        logits, cache = bundle.decode_step(local, cache, tok, mesh=mesh)
        errs.append(float((logits.cpu() - torch.from_numpy(w)).abs().max()))
    return {"errs": errs, "heads": cache["k"].shape[-2]}


def test_mesh_prefill_and_decode_on_the_card(card_pool):
    """Two ranks of one card serve a prompt and 4 teacher-forced tokens
    from their halves of the KV heads: logits within 1e-4 of one
    device's."""
    from repro_torch.models import build
    _no_tf32()
    cfg = _mesh_cfg("llama3_2_1b")
    bundle = build(cfg, device="cuda")
    params = bundle.init(0)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (4, 16))
             .astype(np.int32)}
    feed = rng.integers(0, cfg.vocab_size_real, (4, 4)).astype(np.int32)
    logits, cache = bundle.prefill(params, batch, tp=2, max_len=20)
    want = [logits.cpu().numpy()]
    for tok in feed:
        logits, cache = bundle.decode_step(params, cache, tok)
        want.append(logits.cpu().numpy())
    for r in card_pool.run(_rank_decode, batch, feed, want):
        assert max(r["errs"]) < 1e-4
        assert r["heads"] == cache["k"].shape[-2] // 2


def _family_batch(cfg, rows, seq, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size_real, (rows, seq))
             .astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(rows, 16, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "patches":
        batch["patches"] = rng.normal(size=(rows, 4, cfg.d_model)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b",
                                  "pixtral_12b", "seamless_m4t_medium"])
def test_family_mesh_on_one_rank_of_the_card(cuda, arch):
    """The ssm, hybrid (hymba with its 5 heads), vlm and encdec families
    over a (1,1) mesh of the card (this process alone): the mesh step
    equals the plain step (loss, grad norm, parameters within 1e-6), and
    the mesh forward, prefill and 4 decode steps equal the plain ones
    within 1e-5 (float32, TF32 off)."""
    import torch.distributed as dist
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import (init_train_state,
                                              jit_train_step,
                                              make_train_step)
    _no_tf32()
    changes = {"n_heads": 5, "n_kv_heads": 5} if arch == "hymba_1_5b" \
        else {}
    cfg = _mesh_cfg(arch, **changes)
    bundle = build(cfg, device="cuda")
    batch = _family_batch(cfg, 4, 32, seed=3)
    tc = TrainConfig(warmup_steps=0, learning_rate=1e-3)
    params = bundle.init(0)
    p1, _, m1 = make_train_step(bundle, tc)(
        params.map(lambda _, p: p.clone()), init_opt_state(params), batch)
    feed = np.random.default_rng(4).integers(
        0, cfg.vocab_size_real, (4, 4)).astype(np.int32)

    def serve(mesh):
        out = [bundle.forward(params, batch, mesh=mesh)]
        logits, cache = bundle.prefill(params, batch, mesh=mesh, max_len=36)
        out.append(logits)
        for tok in feed:
            logits, cache = bundle.decode_step(params, cache, tok, mesh=mesh)
            out.append(logits)
        return out
    want = serve(None)
    mesh = make_host_mesh(1, 1, device="cuda")
    try:
        pm, om = init_train_state(params, tc, mesh)
        pm, _, mm = jit_train_step(bundle, tc, mesh)(pm, om, batch)
        got = serve(mesh)
    finally:
        dist.destroy_process_group()
    assert float(mm["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(mm["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-6)
    for a, b in zip(pm.parameters(), p1.parameters()):
        assert a.device.type == "cuda"
        assert float((a - b).abs().max()) <= 1e-6
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5


# -- every compiled launch geometry (kernels/autotune.py's knobs) ------------

@pytest.mark.parametrize("block_q", [16, 32, 64])
@pytest.mark.parametrize("b", PACK_BITS)
@pytest.mark.parametrize("q,n,k", [(4, 300, 33), (37, 1001, 256),
                                   (65, 129, 257)])
def test_collision_every_block_q_matches_plain(cuda, block_q, b, q, n, k):
    """Each compiled query tile at every pack width, Q and N ragged against
    each tile (4 rows: a stream batch), W a multiple of 4 or not."""
    gen = torch.Generator().manual_seed(block_q + b * 1000 + q)
    wq, wn = _words(q, k, b, gen), _words(n, k, b, gen)
    wn[3] = wq[1]
    want = kc.packed_collision_counts_plain(wq, wn, k, b)
    for a, c in ((wq, wn), (_set_bits_past_k(wq, k, b),
                            _set_bits_past_k(wn, k, b))):
        got = kc.packed_collision_counts_kernel(a.to(cuda), c.to(cuda), k, b,
                                                block_q=block_q)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


# each compiled (group, steps) of the probe
PROBE_GEOMETRIES = [(2, 2), (4, 2), (4, 4), (8, 4), (8, 8), (16, 8)]


@pytest.mark.parametrize("group,steps", PROBE_GEOMETRIES)
@pytest.mark.parametrize("ns,w,mp,load", [(3001, 8, 16, 0.95),
                                          (2048, 3, 16, 0.6),
                                          (1021, 7, 5, 0.95)])
def test_probe_every_geometry_matches_plain(cuda, group, steps, ns, w, mp,
                                            load):
    """Each compiled geometry on nearly full tables (spilled keys, chains
    past a round trip, wrapping) and a sparser one (walks that stop early
    at an unused slot), from hashes and from the fold kernel's hashes of
    words."""
    table, qh = _full_range_table(ns, w, mp, load, device=cuda)
    flat = torch.tensor(table.records.reshape(-1, 2 + w))
    h = torch.from_numpy(qh.view(np.int64))
    want = kp.lsh_probe_hashes_plain(flat, h, n_slots=ns, max_probes=mp)
    got = kp.lsh_probe_hashes_kernel(flat.to(cuda), h.to(cuda), n_slots=ns,
                                     max_probes=mp, group=group, steps=steps)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    rng = np.random.default_rng(ns + group)
    words = rng.integers(0, 2**32, (int(0.8 * ns), 3 * 4), dtype=np.uint32)
    wtab = BandedLSHTable(3, n_slots=ns, bucket_width=w, max_probes=mp,
                          device="cpu")
    wtab.insert(band_hashes_packed(words, 3), np.arange(len(words)))
    rows = torch.from_numpy(words[::2].view(np.int32)).reshape(-1, 3, 4)
    wflat = torch.tensor(wtab.records.reshape(-1, 2 + w))
    want = kp.lsh_probe_hashes_plain(wflat, kq.fold_rows_plain(rows),
                                     n_slots=ns, max_probes=mp)
    got = kp.lsh_probe_hashes_kernel(
        wflat.to(cuda), kq.fold_rows_kernel(rows.to(cuda)), n_slots=ns,
        max_probes=mp, group=group, steps=steps)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("threads", [128, 256, 512])
@pytest.mark.parametrize("q,nb,r", [(1, 1, 1), (1088, 32, 8), (7, 5, 13)])
def test_fold_every_block_size_matches_plain(cuda, threads, q, nb, r):
    gen = torch.Generator().manual_seed(q + r + threads)
    rows = torch.randint(-2**31, 2**31 - 1, (q, nb, r), generator=gen,
                         dtype=torch.int32)
    for sign_extend in (False, True):
        want = kq.fold_rows_plain(rows, sign_extend=sign_extend)
        got = kq.fold_rows_kernel(rows.to(cuda), sign_extend=sign_extend,
                                  threads=threads)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("placement", list(_PLACEMENTS))
@pytest.mark.parametrize("d,k", [(2048, 64), (2048, 512), (1 << 16, 256),
                                 ((1 << 16) + 1, 100)])
def test_each_placement_argument_matches_plain(cuda, placement, d, k):
    """Each table placement as the launch argument of the normal entry
    (what the autotuner's signing kinds pass): equal to the plain version
    where it is offered, a refused launch where it is not."""
    from repro_torch.kernels import autotune
    v, pi = _dense_case(5, d, 0.03, seed=d + k + 1)
    p = _PLACEMENTS[placement]
    assert autotune.placement_fits(p, d, k) == \
        {0: d <= 1 << 16, 1: True, 2: k > 64 and d <= _pair_limit(k, 1)}[p]
    if autotune.placement_fits(p, d, k):
        _signing_kernels(v, pi, k, cuda, pack_b=8, placement=p)
    else:
        with pytest.raises(RuntimeError, match="launch failed"):
            kd.cminhash_dense_kernel(v.to(cuda), pi.to(cuda), k, placement=p)
        with pytest.raises(RuntimeError, match="launch failed"):
            kpk.cminhash_packed_kernel(kpk.pack_bits(v).to(cuda),
                                       pi.to(cuda), k, placement=p)
        with pytest.raises(RuntimeError, match="launch failed"):
            ks.cminhash_sparse_kernel(
                torch.zeros((5, 1), dtype=torch.int32, device=cuda),
                pi.to(cuda), k, placement=p)


def test_launch_knobs_outside_the_compiled_instances_are_refused(cuda):
    """A knob value no source compiled raises; nothing falls back."""
    v, pi = _dense_case(3, 256, 0.1, seed=5)
    rows = torch.zeros((4, 2, 8), dtype=torch.int32, device=cuda)
    rec = torch.full((2 * 64, 10), -1, dtype=torch.int32, device=cuda)
    h = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
    words = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    for call in (
            lambda: kd.cminhash_dense_kernel(v.to(cuda), pi.to(cuda), 64,
                                             placement=3),
            lambda: ks.cminhash_sparse_kernel(
                torch.zeros((3, 1), dtype=torch.int32, device=cuda),
                pi.to(cuda), 64, placement=-2),
            lambda: kq.fold_rows_kernel(rows, threads=64),
            lambda: kp.lsh_probe_hashes_kernel(rec, h, n_slots=64,
                                               max_probes=4, group=4,
                                               steps=8),
            lambda: kc.packed_collision_counts_kernel(words, words, 8, 32,
                                                      block_q=48)):
        with pytest.raises(RuntimeError, match="launch failed"):
            call()
            torch.cuda.synchronize()


def test_dry_run_peak_temp_bytes_match_the_card(cuda):
    """The dry run's ``temp_bytes`` (``analysis.hlo``'s most bytes live at
    once, traced on ``meta`` tensors) against the card's caching
    allocator on the same step: a one-device prefill of 4,096 tokens
    through llama3_2_1b at full width and 2 layers.  The card's peak
    beyond what was allocated before the call (the second call: cuBLAS's
    workspace is allocated by then) is within 2% of the trace's; the
    allocator rounds each block up to 512 bytes."""
    from repro_torch.analysis import hlo
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config("llama3_2_1b"), n_layers=2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 4096),
                           generator=torch.Generator().manual_seed(0))
    meta = build(cfg, device="meta")
    want = hlo.analyze(lambda p, t: meta.prefill(p, {"tokens": t}),
                       meta.init(0), tokens.to("meta")).peak_temp_bytes
    bundle = build(cfg, device=cuda)
    params = bundle.init(0)
    tok = tokens.to(cuda)
    out = bundle.prefill(params, {"tokens": tok})
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = bundle.prefill(params, {"tokens": tok})
    torch.cuda.synchronize()
    got = torch.cuda.max_memory_allocated() - base
    print(f"prefill peak beyond the arguments: {got} bytes on the card, "
          f"{want:.0f} traced")
    assert got == pytest.approx(want, rel=0.02)


def test_every_wrapper_resolves_its_knobs_once_a_launch(cuda, monkeypatch):
    """On the card each wrapper asks ``autotune.recommend`` once a launch
    for the knobs it is not given, and not at all when they are given."""
    from test_torch_autotune import _calls, spy_recommend
    seen = spy_recommend(monkeypatch)
    for key, call in _calls("cuda").items():
        seen.clear()
        call()
        assert seen == [(*key[:4], "cuda")], key
    torch.cuda.synchronize()
    seen.clear()
    kc.collision_counts_kernel(
        torch.zeros((2, 3), dtype=torch.int32, device=cuda),
        torch.zeros((4, 3), dtype=torch.int32, device=cuda), block_q=16)
    kp.lsh_probe_hashes_kernel(
        torch.full((64, 5), -1, dtype=torch.int32, device=cuda),
        torch.zeros((2, 1), dtype=torch.int64, device=cuda), n_slots=64,
        max_probes=2, group=8, steps=4)
    torch.cuda.synchronize()
    assert seen == []


@pytest.mark.parametrize("kind,b,d,k,nnz", [
    ("sparse", 64, 1 << 16, 256, 254), ("dense_rows", 16, 2048, 512, 0),
    ("dense_bits", 16, 1 << 14, 256, 0), ("fold", 64, 32, 8, 0),
    ("probe", 2048, 4096, 8, 0), ("collision", 4, 4096, 256, 0)])
def test_autotune_measure_on_the_card(cuda, tmp_path, monkeypatch, kind, b,
                                      d, k, nnz):
    """A default sweep of each kind on the card caches a winner that a
    fresh cache reads back from the file, and the wrapper launched with it
    equals its plain version."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    autotune.clear_cache()
    try:
        best = autotune.measure(kind, b, d, k, nnz=nnz, warmup=1, iters=2)
        autotune.clear_cache()
        assert autotune.recommend(kind, b, d, k, backend="cuda",
                                  nnz=nnz) == best
        runner = autotune._make_runner(kind, b, d, k, nnz, 0, "cuda")
        got = runner(best)()
        torch.cuda.synchronize()
        assert torch.equal(got, runner.plain())
    finally:
        autotune.clear_cache()


# -- the selective scan (csrc/ssm_scan.cu) -------------------------------------
#
# Tolerance: 1e-5 of the largest |value| (y or h), against the plain version
# (the same order, one position at a time: the kernel contracts h's update and
# y's sum into FMAs, ~1 ulp a step, damped by the decays) and against the
# chunked scan ``_ssm_inner`` (the decays multiplied in another order).

SCAN_TOL = 1e-5


def _scan_operands(cuda, b, s, di, n, dtype, seed):
    """(dt, a, B, C, x, h0) as ``ssm_block`` makes them, on the card."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, di, generator=gen, device=cuda) * 0.5 - 4.6)
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=cuda) \
        * torch.rand(di, 1, generator=gen, device=cuda).add(0.5)
    bm, cm, xs = (torch.randn(*shape, generator=gen, device=cuda).to(dtype)
                  for shape in ((b, s, n), (b, s, n), (b, s, di)))
    h0 = torch.randn(b, di, n, generator=gen, device=cuda)
    return dt, a.contiguous(), bm, cm, xs, h0


def _scan_err(got, want) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.numel() == 0:
        return 0.0
    scale = float(want.abs().max()) or 1.0
    return float((got.double() - want.double()).abs().max()) / scale


def _scan_close(got, ops, inner=True):
    from repro_torch.models.ssm import _ssm_inner
    wants = [kss.ssm_scan_plain(*ops)]
    if inner and ops[0].shape[1]:
        wants.append(_ssm_inner(*ops, 32, torch.float32))
    for want in wants:
        assert _scan_err(got[0], want[0]) < SCAN_TOL
        assert _scan_err(got[1], want[1]) < SCAN_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssm_scan_kernel_at_the_cells_widths(cuda, dtype):
    """B 2, S 1,024, Di 8,192, N 16 (AI21-Jamba2-Mini's Mamba layers; B 2
    splits each channel over 4 lanes), then the same rows through one lane
    a channel, as B 16 runs."""
    ops = _scan_operands(cuda, 2, 1024, 8192, 16, dtype, seed=11)
    got = kss.ssm_scan_kernel(*ops)
    torch.cuda.synchronize()
    _scan_close(got, ops)
    one_lane = kss._launch(*ops, lanes=1)
    torch.cuda.synchronize()
    _scan_close(one_lane, ops, inner=False)


@pytest.mark.parametrize("s", [0, 1, 5, 13, 64])
@pytest.mark.parametrize("di,n", [(130, 16), (200, 8), (202, 8), (256, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_ssm_scan_kernel_on_ragged_shapes(cuda, s, di, n, dtype, lanes):
    """S of 0, 1, below and not a multiple of the 8-position tile; Di not a
    multiple of a block's channels, and 202 (rows not on 16 bytes: the
    plain-load staging); N 8 and 16; non-zero h0; every lane split."""
    ops = _scan_operands(cuda, 3, s, di, n, dtype, seed=s * 7 + di + n)
    got = kss._launch(*ops, lanes=lanes)
    torch.cuda.synchronize()
    assert got[0].shape == (3, s, di) and got[1].shape == (3, di, n)
    _scan_close(got, ops)


def test_ssm_scan_kernel_on_views_of_unaligned_storage(cuda):
    """Operands that start off 16 bytes (views one element in): the
    plain-load staging, the same answers."""
    ops = _scan_operands(cuda, 2, 21, 256, 16, torch.bfloat16, seed=5)
    shifted = []
    for t in ops:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        shifted.append(view)
    got = kss.ssm_scan_kernel(*shifted)
    torch.cuda.synchronize()
    _scan_close(got, ops)


def test_ssm_scan_kernel_refuses_a_cpu_or_strided_operand(cuda):
    ops = list(_scan_operands(cuda, 2, 5, 128, 16, torch.bfloat16, seed=1))
    with pytest.raises(ValueError, match="h0 is on cpu"):
        kss.ssm_scan_kernel(*ops[:5], ops[5].cpu())
    strided = torch.empty(2, 5, 32, dtype=torch.bfloat16, device=cuda)
    strided = strided[:, :, ::2]
    strided.copy_(ops[3])
    with pytest.raises(ValueError, match="cmat must be contiguous"):
        kss.ssm_scan_kernel(*ops[:3], strided, *ops[4:])


def _mamba_cfg(arch="falcon_mamba_7b", **changes):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **changes)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "jamba2_mini"])
def test_prefill_through_the_scan_kernel_never_waits_for_the_card(cuda,
                                                                  arch):
    """A bf16 prefill at reduced widths queues its work, the scan kernel's
    launches included, with no host sync."""
    from repro_torch.models import build
    cfg = _mamba_cfg(arch)
    bundle = build(cfg, device="cuda")
    params = bundle.init(0)
    tok = torch.randint(0, cfg.vocab_size_real or cfg.vocab_size, (4, 40),
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    n_ssm = sum("ssm" in cfg.mixer(i) for i in range(cfg.n_layers))
    with torch.no_grad():
        bundle.prefill(params, {"tokens": tok})          # builds, warms up
        torch.cuda.synchronize()
        before = kss.KERNEL.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = bundle.prefill(params, {"tokens": tok})
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert kss.KERNEL.launches - before == n_ssm > 0
    assert bool(torch.isfinite(logits).all())


def test_ssm_block_takes_the_kernel_only_without_grad_in_float32(cuda):
    """Under ``no_grad`` one launch a call, equal to the chunked scan's
    block; with a gradient wanted, or ``ssm_scan_dtype="bfloat16"``, none."""
    from repro_torch.models import ssm as t_ssm
    cfg = _mamba_cfg(dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = t_ssm.init_ssm(gen, cfg, torch.float32)
    x = torch.randn(2, 37, cfg.d_model, generator=gen, device=cuda)
    n0 = kss.KERNEL.launches
    with torch.no_grad():
        got = t_ssm.ssm_block(p, x, cfg)
        assert kss.KERNEL.launches == n0 + 1
        want = t_ssm.ssm_block(p, x, dataclasses.replace(
            cfg, ssm_scan_dtype="bfloat16"))
        assert kss.KERNEL.launches == n0 + 1
    grad_p = {k: v.clone().requires_grad_() for k, v in p.items()}
    chunked = t_ssm.ssm_block(grad_p, x, cfg)
    assert kss.KERNEL.launches == n0 + 1
    chunked[0].float().sum().backward()
    assert grad_p["a_log"].grad is not None
    torch.cuda.synchronize()
    for g, w in zip(got, chunked):
        assert _scan_err(g, w.detach()) < SCAN_TOL
    # the bf16 scan is another function: it lands elsewhere
    assert _scan_err(got[0], want[0]) > SCAN_TOL
