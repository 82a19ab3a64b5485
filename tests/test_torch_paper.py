"""The paper-side modules of the PyTorch port against the JAX package.

C-MinHash's Algorithms 2/3 (``core.cminhash``), the permutation helpers,
classical MinHash under the reference's own K permutations, the Jaccard
estimators, b-bit hashing, the synthetic binary datasets, and the Fig. 7
MAE computation as a whole on a small corpus.  Integer outputs and
count.float32 / k scores: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bbit as ref_bbit
from repro.core import cminhash as ref_cminhash
from repro.core import estimators as ref_est
from repro.core import minhash as ref_minhash
from repro.core import permutations as ref_perm
from repro.data import synthetic as ref_syn
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.core import bbit as t_bbit
from repro_torch.core import cminhash as t_cminhash
from repro_torch.core import estimators as t_est
from repro_torch.core import minhash as t_minhash
from repro_torch.core import permutations as t_perm
from repro_torch.data import synthetic as t_syn
from repro_torch.kernels import ops as t_ops

SENTINEL = 2 ** 31 - 1


def _binary(b, d, dens, seed):
    rng = np.random.default_rng(seed)
    v = (rng.random((b, d)) < dens).astype(np.int8)
    v[0] = 0
    return v


def _sparse_lists(v):
    nnz = max(1, int(v.sum(axis=1).max()))
    idx = np.full((len(v), nnz), -1, np.int32)
    for i, row in enumerate(v):
        z = np.flatnonzero(row)
        idx[i, : len(z)] = z
    return idx


def _perms(d, seed):
    sigma, pi = ref_perm.make_two_permutations(jax.random.PRNGKey(seed), d)
    return np.asarray(sigma), np.asarray(pi)


# -- permutations -------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 7, 300])
def test_permutation_helpers_match_reference(d):
    sigma, pi = _perms(d, d)
    v = _binary(4, d, 0.3, d)
    v[1] = np.arange(d) % 5 - 2                  # values other than 0/1
    ts = torch.tensor(sigma)
    assert np.array_equal(
        t_perm.apply_permutation_dense(torch.tensor(v), ts).numpy(),
        np.asarray(ref_perm.apply_permutation_dense(jnp.asarray(v),
                                                    jnp.asarray(sigma))))
    inv = t_perm.invert_permutation(ts)
    assert inv.dtype == torch.int32
    assert np.array_equal(inv.numpy(), np.asarray(
        ref_perm.invert_permutation(jnp.asarray(sigma))))
    for k in (0, 1, d // 2, d + 3):
        assert np.array_equal(
            t_perm.circulant_shift(torch.tensor(pi), k).numpy(),
            np.asarray(ref_perm.circulant_shift(jnp.asarray(pi), k)))


# -- C-MinHash, Algorithms 2/3 ------------------------------------------------

@pytest.mark.parametrize("b,d,k,dens", [(3, 100, 37, 0.05), (4, 257, 257, 0.3),
                                        (2, 64, 1, 0.9), (5, 96, 50, 0.0)])
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("with_sigma", [False, True])
def test_cminhash_dense_and_sparse_match_reference(b, d, k, dens, off,
                                                   with_sigma):
    v = _binary(b, d, dens, b * d + k)
    idx = _sparse_lists(v)
    sigma, pi = _perms(d, k + off)
    jsig = jnp.asarray(sigma) if with_sigma else None
    tsig = torch.tensor(sigma) if with_sigma else None
    want = np.asarray(ref_cminhash.cminhash_dense(
        jnp.asarray(v), jnp.asarray(pi), k, jsig, shift_offset=off))
    got = t_cminhash.cminhash_dense(torch.tensor(v), torch.tensor(pi), k,
                                    tsig, shift_offset=off)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    want_s = np.asarray(ref_cminhash.cminhash_sparse(
        jnp.asarray(idx), jnp.asarray(pi), k, jsig, shift_offset=off))
    got_s = t_cminhash.cminhash_sparse(torch.tensor(idx), torch.tensor(pi), k,
                                       tsig, shift_offset=off)
    assert np.array_equal(got_s.numpy(), want_s)
    assert np.array_equal(want_s, want)
    for layout, data in (("dense", v), ("sparse", idx)):
        assert torch.equal(t_cminhash.compute_signatures(
            torch.tensor(data), torch.tensor(pi), k, tsig, layout=layout,
            shift_offset=off), got)


def test_cminhash_chunking_and_refusals(monkeypatch):
    """Temporaries cut into row and hash chunks give the same signatures."""
    v = _binary(9, 130, 0.2, 1)
    idx = _sparse_lists(v)
    _, pi = _perms(130, 1)
    tv, ti, tpi = torch.tensor(v), torch.tensor(idx), torch.tensor(pi)
    whole = t_cminhash.cminhash_dense(tv, tpi, 77)
    monkeypatch.setattr(t_cminhash, "_BUDGET", 300)
    assert torch.equal(t_cminhash.cminhash_dense(tv, tpi, 77), whole)
    assert torch.equal(t_cminhash.cminhash_sparse(ti, tpi, 77), whole)
    with pytest.raises(ValueError, match="K <= D"):
        t_cminhash.cminhash_dense(tv, tpi, 131)
    with pytest.raises(ValueError, match="layout"):
        t_cminhash.compute_signatures(tv, tpi, 8, layout="csr")
    empty = torch.zeros((2, 0), dtype=torch.int32)
    assert (t_cminhash.cminhash_sparse(empty, tpi, 5) == SENTINEL).all()


# -- classical MinHash --------------------------------------------------------

@pytest.mark.parametrize("b,d,k,dens", [(4, 100, 37, 0.1), (3, 257, 64, 0.5),
                                        (2, 64, 1, 0.0)])
def test_minhash_matches_reference_under_its_permutations(b, d, k, dens):
    perms = np.asarray(ref_minhash.make_k_permutations(
        jax.random.PRNGKey(d), d, k))
    tperms = convert.k_permutations_from_jax(perms, "cpu")
    assert tperms.dtype == torch.int32 and tperms.shape == (k, d)
    v = _binary(b, d, dens, d + k)
    idx = _sparse_lists(v)
    want = np.asarray(ref_minhash.minhash_dense(jnp.asarray(v),
                                                jnp.asarray(perms)))
    got = t_minhash.minhash_dense(torch.tensor(v), tperms)
    assert np.array_equal(got.numpy(), want)
    want_s = np.asarray(ref_minhash.minhash_sparse(jnp.asarray(idx),
                                                   jnp.asarray(perms)))
    got_s = t_minhash.minhash_sparse(torch.tensor(idx), tperms)
    assert np.array_equal(got_s.numpy(), want_s)
    assert (got[0] == SENTINEL).all()


def test_make_k_permutations_and_the_carried_set():
    gen = torch.Generator().manual_seed(0)
    perms = t_minhash.make_k_permutations(gen, 50, 6, device="cpu")
    assert perms.dtype == torch.int32 and perms.shape == (6, 50)
    for p in perms:
        assert torch.equal(p.sort().values,
                           torch.arange(50, dtype=torch.int32))
    assert not torch.equal(perms[0], perms[1])
    with pytest.raises(ValueError, match="not a permutation"):
        convert.k_permutations_from_jax(np.zeros((2, 5), np.int32), "cpu")
    with pytest.raises(ValueError, match=r"\(K, D\)"):
        convert.k_permutations_from_jax(np.arange(5), "cpu")


# -- estimators and b-bit hashing ---------------------------------------------

@pytest.mark.parametrize("q,n,k", [(4, 6, 64), (3, 5, 37), (1, 1, 1)])
def test_estimators_match_reference(q, n, k):
    rng = np.random.default_rng(q + n + k)
    sq = rng.integers(0, 4, (q, k), dtype=np.int32)
    sn = np.concatenate([sq, rng.integers(0, 4, (n, k), dtype=np.int32)])
    jq, jn, tq, tn = (jnp.asarray(sq), jnp.asarray(sn), torch.tensor(sq),
                      torch.tensor(sn))
    got = t_est.pairwise_jaccard_from_signatures(tq, tn)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(
        ref_est.pairwise_jaccard_from_signatures(jq, jn)))
    assert np.array_equal(
        t_est.jaccard_from_signatures(tq, tn[:q]).numpy(),
        np.asarray(ref_est.jaccard_from_signatures(jq, jn[:q])))
    assert np.array_equal(t_ops.estimated_jaccard_matrix(tq, tn).numpy(),
                          np.asarray(ref_ops.estimated_jaccard_matrix(
                              jq, jn, use_kernel=False)))
    v = _binary(q + 1, 80, 0.2, k)
    w = _binary(q + 1, 80, 0.3, k + 1)
    w[1] = v[1]
    assert np.array_equal(
        t_est.true_jaccard_dense(torch.tensor(v), torch.tensor(w)).numpy(),
        np.asarray(ref_est.true_jaccard_dense(jnp.asarray(v), jnp.asarray(w))))
    est = got.numpy().ravel()
    truth = rng.random(est.shape).astype(np.float32)
    assert t_est.mae(est, truth) == ref_est.mae(est, truth)
    assert t_est.mse(est, truth) == ref_est.mse(est, truth)
    a, b = _sparse_lists(v)[1], _sparse_lists(w)[1]
    assert t_est.true_jaccard_sparse(a, b) == ref_est.true_jaccard_sparse(a, b)
    assert t_est.true_jaccard_sparse([-1], [-1]) == 0.0


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_bbit_matches_reference(b):
    rng = np.random.default_rng(b)
    sa = rng.integers(-2 ** 31, 2 ** 31, (5, 40), dtype=np.int64) \
        .astype(np.int32)
    sb = np.where(rng.random((5, 40)) < 0.5, sa,
                  rng.integers(0, 2 ** 31, (5, 40))).astype(np.int32)
    ja, jb, ta, tb = (jnp.asarray(sa), jnp.asarray(sb), torch.tensor(sa),
                      torch.tensor(sb))
    assert np.array_equal(t_bbit.lowest_b_bits(ta, b).numpy(),
                          np.asarray(ref_bbit.lowest_b_bits(ja, b)))
    feats = t_bbit.bbit_features(ta, b)
    assert feats.dtype == torch.float32 and feats.shape == (5, 40 << b)
    assert np.array_equal(feats.numpy(),
                          np.asarray(ref_bbit.bbit_features(ja, b)))
    assert np.array_equal(t_bbit.bbit_collision_fraction(ta, tb, b).numpy(),
                          np.asarray(ref_bbit.bbit_collision_fraction(
                              ja, jb, b)))


# -- synthetic binary datasets ------------------------------------------------

@pytest.mark.parametrize("structured", [True, False])
def test_binary_pairs_match_reference(structured):
    want = ref_syn.binary_pairs(np.random.default_rng(3), 5, 64, 30, 12,
                                structured=structured)
    got = t_syn.binary_pairs(np.random.default_rng(3), 5, 64, 30, 12,
                             structured=structured)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got, want))


@pytest.mark.parametrize("kind,kw", [
    ("textlike", {"mean_nnz": 80}), ("textlike", {"mean_nnz": 250}),
    ("imagelike", {"block": 16}), ("imagelike", {"block": 64, "p_on": 0.5})])
def test_binary_datasets_match_reference(kind, kw):
    name = f"{kind}_binary_dataset"
    want = getattr(ref_syn, name)(np.random.default_rng(0), 12, 2048, **kw)
    got = getattr(t_syn, name)(np.random.default_rng(0), 12, 2048, **kw)
    assert got.dtype == want.dtype == np.int8
    assert np.array_equal(got, want)


# -- Fig. 7 as a whole --------------------------------------------------------

def _pairwise_mae(est: np.ndarray, truth: np.ndarray) -> float:
    iu = np.triu_indices(len(est), 1)
    return float(np.abs(est[iu] - truth[iu]).mean())


@pytest.mark.parametrize("kind,kw", [("textlike", {"mean_nnz": 80}),
                                     ("imagelike", {"block": 16})])
def test_fig7_mae_matches_reference(kind, kw):
    """bench_mae's computation on a small corpus: the three methods'
    estimates and the exact Jaccard equal the reference's, so their MAEs
    are the same numbers."""
    d, k, n = 2048, 64, 10
    data = getattr(t_syn, f"{kind}_binary_dataset")(
        np.random.default_rng(0), n, d, **kw)
    key = jax.random.PRNGKey(1)
    sigma, pi = ref_perm.make_two_permutations(key, d)
    perms = ref_minhash.make_k_permutations(key, d, k)
    vj = jnp.asarray(data)
    truth = np.stack([np.asarray(ref_est.true_jaccard_dense(vj[i][None], vj))
                      for i in range(n)])
    ref_sigs = {
        "MH": ref_minhash.minhash_dense(vj, perms),
        "C0": ref_ops.cminhash_signatures(vj, pi, k, None, impl="ref"),
        "Cs": ref_ops.cminhash_signatures(vj, pi, k, sigma, impl="ref")}
    tv = torch.tensor(data)
    tsigma, tpi = convert.permutations_from_jax(np.asarray(sigma),
                                                np.asarray(pi), "cpu")
    port_sigs = {
        "MH": t_minhash.minhash_dense(
            tv, convert.k_permutations_from_jax(np.asarray(perms), "cpu")),
        "C0": t_ops.cminhash_signatures(tv, tpi, k),
        "Cs": t_ops.cminhash_signatures(tv, tpi, k, tsigma)}
    ttruth = t_est.true_jaccard_dense(tv[:, None, :], tv[None, :, :]).numpy()
    assert np.array_equal(ttruth, truth)
    for name in ref_sigs:
        want = np.asarray(ref_est.pairwise_jaccard_from_signatures(
            ref_sigs[name], ref_sigs[name]))
        got = t_ops.estimated_jaccard_matrix(port_sigs[name],
                                             port_sigs[name]).numpy()
        assert np.array_equal(got, want), name
        assert _pairwise_mae(got, ttruth) == _pairwise_mae(want, truth)
