"""The top-k select (``kernels/topk_select.py``, ``csrc/topk_select.cu``)
and the planner's ranking through it.

On the CPU: the plain version against the reference's order,
``np.argsort(-scored, kind="stable")`` (count desc, column asc), on rows of
equal counts, ties across the kk-th place, -1 masked entries and rows,
kk > U, U = 1, U not a multiple of 4, kk above the kernel's 32 keys a
pass; the planner's brute-force and masked partials against a numpy count
and argsort, and the ``select`` tag of ``query.fallback.sort``.  On a card
(``cuda`` marker, skipped without one): the kernel against the plain
version bit for bit on the same cases, on every instance and on passes
after the first, at both benchmark cells' shapes and on a view of padded
counts, each launch synchronised; the planner's answers on the card
against the CPU's.  (``tests/test_torch_store.py`` holds the CPU store's
tied brute-force answers to the JAX package's.)  Imports neither jax nor
repro:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_topk_select.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import topk_select as kt
from repro_torch.obs import trace as obs_trace
from repro_torch.store import SketchStore, StoreConfig
from repro_torch.store.packed import pack_host

from test_torch_cuda import cuda  # noqa: F401  (the card fixture)

K = 64
PASS = 32         # the kernel's keys a pass (csrc/topk_select.cu)


def _reference(counts: np.ndarray, kk: int):
    """The JAX package's order: a stable argsort of -score, first kk."""
    order = np.argsort(-counts.astype(np.int64), axis=1, kind="stable")[:, :kk]
    return np.take_along_axis(counts, order, axis=1), order


def _cases():
    """name -> ((Q, U) int32 counts, kk)."""
    rng = np.random.default_rng(7)
    straddle = rng.integers(0, 4, (6, 50))
    straddle[0] = [9, 5, 5, 5, 5, 5, 5] + [1] * 43       # 6 tied at kk 3
    masked = rng.integers(-1, 6, (5, 203))
    masked[2] = -1                                      # nothing unmasked
    masked[3, ::2] = -1
    big = np.array([[0, 2**31 - 1, -1, 2**31 - 2, 2**31 - 1, 7, -1, 0]])
    return {
        "all_equal": (np.full((4, 37), 7), 5),
        "ties_straddle_kk": (straddle, 3),
        "masked_and_all_masked": (masked, 10),
        "kk_above_u_of_1": (rng.integers(-1, 9, (3, 1)), 5),
        "u_not_multiple_of_4": (rng.integers(0, 40, (7, 1027)), 10),
        "long_rows": (rng.integers(0, 30, (3, 9001)), 8),
        "count_range_ends": (big, 6),
        "kk_above_kmax": (rng.integers(0, 12, (4, 300)), PASS + 8),
        "ties_across_passes": (rng.integers(-1, 3, (5, 501)), 3 * PASS + 7),
    }


CASES = _cases()


def _as_tensor(counts, device="cpu"):
    return torch.tensor(np.asarray(counts), dtype=torch.int32, device=device)


# -- the plain version on the CPU ---------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_the_reference_order(name):
    counts, kk = CASES[name]
    values, cols = kt.topk_select_plain(_as_tensor(counts), kk)
    want_v, want_c = _reference(np.asarray(counts, np.int32), kk)
    assert values.dtype == torch.int32 and cols.dtype == torch.int64
    assert values.shape == (len(counts), min(kk, np.shape(counts)[1]))
    assert np.array_equal(values.numpy(), want_v)
    assert np.array_equal(cols.numpy(), want_c)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_select_on_the_cpu_is_the_plain_version(name):
    counts, kk = CASES[name]
    t = _as_tensor(counts)
    *got, path = ops.topk_select(t, kk)
    want = kt.topk_select_plain(t, kk)
    assert path == "sort"
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_select_path_rests_on_device_and_kk():
    """The path is the device's alone: the CPU sorts at every kk; the
    kernel takes only a CUDA tensor, and no negative kk."""
    t = torch.zeros((3, 100), dtype=torch.int32)
    for kk in (0, 5, PASS, PASS + 8, 100, 101):
        assert ops.topk_select(t, kk)[2] == "sort"
    with pytest.raises(ValueError, match="kk"):
        kt.topk_select_kernel(torch.zeros((2, 3), dtype=torch.int32), -1)
    with pytest.raises(ValueError, match="CUDA"):
        kt.topk_select_kernel(t, 5)


# -- the planner on the CPU ---------------------------------------------------

def _tied_store(device, n=400, seed=3):
    """A store of K = 64 codes drawn from 4 values: counts near K / 4, so
    most scores tie with many others."""
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 4, (n, K)).astype(np.int32)
    q = rng.integers(0, 4, (37, K)).astype(np.int32)
    q[5] = sigs[17]                                     # an exact match
    store = SketchStore(StoreConfig(k=K, n_bands=16, rows_per_band=4,
                                    n_slots=256), device=device)
    store.add(sigs)
    return store, sigs, q


def _brute_reference(sigs, q, top_k):
    counts = (q[:, None, :] == sigs[None, :, :]).sum(-1)
    kk = min(top_k, len(sigs))
    top, order = _reference(counts, kk)
    ids = np.full((len(q), top_k), -1, np.int64)
    scores = np.full((len(q), top_k), -np.inf, np.float32)
    ids[:, :kk] = order
    scores[:, :kk] = top.astype(np.float32) / np.float32(K)
    return ids, scores


def _traced_brute(store, qwords, top_k):
    """(partial, the ``query.fallback.sort`` spans' tags) of one traced
    brute-force call."""
    tracer = obs_trace.Tracer(sample_rate=1.0)
    before = obs_trace.set_default(tracer)
    try:
        with tracer.span("store.query"):
            part = store.planner.brute_partial_packed(qwords, top_k)
    finally:
        obs_trace.set_default(before)
    tags = [s["tags"] for s in tracer.drain()
            if s["name"] == "query.fallback.sort"]
    return part, tags


@pytest.mark.parametrize("top_k", [5, 10, PASS + 8])
def test_brute_partial_on_the_cpu_matches_the_reference(top_k):
    store, sigs, q = _tied_store("cpu")
    part, tags = _traced_brute(store, pack_host(q, 32), top_k)
    ids, scores = _brute_reference(sigs, q, top_k)
    assert np.array_equal(part.ids, ids)
    assert np.array_equal(part.scores, scores)
    assert tags == [{"select": "sort"}]


def test_masked_partial_on_the_cpu_matches_the_reference():
    store, sigs, q = _tied_store("cpu")
    rng = np.random.default_rng(11)
    cand = rng.integers(-1, len(sigs), (len(q), 24))
    cand[4] = -1                                        # no candidate
    part = store.planner.partial_topk_packed(pack_host(q, 32), cand, 10)
    counts = (q[:, None, :] == sigs[None, :, :]).sum(-1)
    for r in range(len(q)):
        c = np.unique(cand[r][cand[r] >= 0])
        if not len(c):
            assert not part.has_candidates[r] and (part.ids[r] == -1).all()
            continue
        top, order = _reference(counts[r, c][None], 10)
        n = top.shape[1]
        assert np.array_equal(part.ids[r, :n], c[order[0]])
        assert np.array_equal(part.scores[r, :n],
                              top[0].astype(np.float32) / np.float32(K))
        assert (part.ids[r, n:] == -1).all()


# -- the kernel on the card ---------------------------------------------------

def _kernel_and_plain(counts: torch.Tensor, kk: int):
    before = kt.KERNEL.launches
    got = kt.topk_select_kernel(counts, kk)
    torch.cuda.synchronize()
    launched = kt.KERNEL.launches - before
    want = kt.topk_select_plain(counts, kk)
    return got, want, launched


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_the_card(cuda, name):
    counts, kk = CASES[name]
    t = _as_tensor(counts, cuda)
    (v, c), (wv, wc), launched = _kernel_and_plain(t, kk)
    assert launched == 1
    assert ops.topk_select(t, kk)[2] == "kernel"
    assert v.dtype == wv.dtype and c.dtype == wc.dtype
    assert torch.equal(v, wv) and torch.equal(c, wc)


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [1, 2, 8, 9, 16, 17, 31, 32, 33, 40, 64, 65,
                                100])
def test_every_kernel_instance_matches_plain(cuda, kk):
    gen = torch.Generator(device=cuda).manual_seed(kk)
    t = torch.randint(-1, 20, (9, 4099), generator=gen, device=cuda,
                      dtype=torch.int32)
    (v, c), (wv, wc), launched = _kernel_and_plain(t, kk)
    assert launched == 1
    assert torch.equal(v, wv) and torch.equal(c, wc)


@pytest.mark.cuda
@pytest.mark.parametrize("q,u,kk", [(1240, 262_144, 5), (500, 69_363, 10),
                                    (1240, 262_144, PASS + 8)],
                         ids=["web_crawl_mixed", "ml10m_knn",
                              "web_crawl_mixed_two_passes"])
def test_kernel_at_the_cells_shapes(cuda, q, u, kk):
    gen = torch.Generator(device=cuda).manual_seed(q)
    t = torch.randint(0, 40, (q, u), generator=gen, device=cuda,
                      dtype=torch.int32)
    t[::7, u // 3] = 256                                # a self-match
    (v, c), (wv, wc), launched = _kernel_and_plain(t, kk)
    assert launched == 1
    assert torch.equal(v, wv) and torch.equal(c, wc)


@pytest.mark.cuda
@pytest.mark.parametrize("u", [262_144, 69_363])
def test_kernel_on_a_view_of_padded_counts(cuda, u):
    """``counts[:q]`` of a matrix padded to a power of two of rows, as the
    fallback selects its real rows."""
    gen = torch.Generator(device=cuda).manual_seed(u)
    padded = torch.randint(0, 30, (64, u), generator=gen, device=cuda,
                           dtype=torch.int32)
    view = padded[:37]
    assert view.is_contiguous()
    (v, c), (wv, wc), launched = _kernel_and_plain(view, 5)
    assert launched == 1 and v.shape == (37, 5)
    assert torch.equal(v, wv) and torch.equal(c, wc)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    t = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kt.topk_select_kernel(t[:, 1:], 5)
    with pytest.raises(TypeError, match="int32"):
        kt.topk_select_kernel(t.to(torch.int64), 5)
    v, c = kt.topk_select_kernel(t[:0], 5)
    assert v.shape == (0, 5) and c.shape == (0, 5)
    v, c = kt.topk_select_kernel(t, 0)
    assert v.shape == (4, 0) and c.shape == (4, 0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [5, 10, PASS + 8])
def test_brute_partial_on_the_card_matches_the_cpu(cuda, top_k):
    card, _, q = _tied_store("cuda")
    host, _, _ = _tied_store("cpu")
    before = kt.KERNEL.launches
    got, tags = _traced_brute(card, pack_host(q, 32), top_k)
    torch.cuda.synchronize()
    want, cpu_tags = _traced_brute(host, pack_host(q, 32), top_k)
    assert np.array_equal(got.ids, want.ids)
    assert np.array_equal(got.scores, want.scores)
    assert kt.KERNEL.launches - before == 1
    assert tags == [{"select": "kernel"}]
    assert cpu_tags == [{"select": "sort"}]


@pytest.mark.cuda
def test_masked_partial_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(11)
    cand = rng.integers(-1, 400, (37, 24))
    cand[4] = -1
    parts = []
    for device in ("cuda", "cpu"):
        store, _, q = _tied_store(device)
        parts.append(store.planner.partial_topk_packed(pack_host(q, 32),
                                                       cand, 10))
    assert np.array_equal(parts[0].ids, parts[1].ids)
    assert np.array_equal(parts[0].scores, parts[1].scores)
    assert np.array_equal(parts[0].has_candidates, parts[1].has_candidates)
