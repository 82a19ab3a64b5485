"""Sparse signing in the PyTorch port, bit for bit against the JAX package.

The port's sparse window-min (its plain version on the CPU, through the
same wrapper the CUDA kernel sits behind) against
``dispatch.signatures_sparse`` with ``impl="windows"`` and ``"gather"``, the
Pallas kernel in interpret mode, and ``SketchEngine.sign`` with the
reference's permutations carried across.  Tolerance: 0 (integer codes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import SketchConfig as RefSketchConfig
from repro.core.engine import SketchEngine as RefSketchEngine
from repro.core.permutations import apply_permutation_sparse
from repro.core.permutations import make_two_permutations as ref_perms
from repro.kernels import cminhash_sparse as ref_sparse
from repro.kernels import dispatch as ref_dispatch
from repro.kernels.packfmt import PACK_BITS
from repro_torch import convert
from repro_torch.core.engine import SketchConfig, SketchEngine
from repro_torch.device import u32_to_host
from repro_torch.kernels import cminhash_sparse as t_sparse
from repro_torch.kernels import dispatch as t_dispatch


def _case(b, nnz, d, seed):
    """Padded index lists with empty rows, padding gaps and duplicates of
    the boundary values 0 and d-1."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (b, nnz), dtype=np.int32)
    idx[:, -3:] = -1
    idx[1] = -1                                  # a row with no valid index
    idx[2, :2] = [0, d - 1]
    sigma, pi = ref_perms(jax.random.PRNGKey(seed), d)
    return idx, np.asarray(sigma), np.asarray(pi)


def _port(idx, sigma, pi, k, **kw):
    ts, tp = convert.permutations_from_jax(sigma, pi, "cpu")
    return t_dispatch.signatures_sparse(torch.tensor(idx), tp, k, ts, **kw)


@pytest.mark.parametrize("d,k", [(257, 32), (4096, 64), ((1 << 16) + 3, 40)])
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("impl", ["windows", "gather"])
def test_sparse_signatures_match_reference(d, k, off, impl):
    idx, sigma, pi = _case(6, 37, d, seed=d + off)   # NNZ=37: no tile divides
    want = np.asarray(ref_dispatch.signatures_sparse(
        jnp.asarray(idx), jnp.asarray(pi), k, jnp.asarray(sigma),
        shift_offset=off, impl=impl))
    got = _port(idx, sigma, pi, k, shift_offset=off)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want[1] == t_sparse.SENTINEL).all()      # the empty row


@pytest.mark.parametrize("impl", ["windows", "gather"])
def test_unpermuted_out_of_range_indices_wrap_like_reference(impl):
    """With no sigma the caller's indices reach the kernel as they are; an
    index >= D wraps mod D in the reference, and so in the port."""
    d, k = 300, 48
    idx, _, pi = _case(5, 19, d, seed=7)
    idx[0, :4] = [d, 3 * d + 5, 2 ** 31 - 1, d - 1]
    idx[3] = np.arange(19) * 997 + d
    want = np.asarray(ref_dispatch.signatures_sparse(
        jnp.asarray(idx), jnp.asarray(pi), k, impl=impl))
    got = t_dispatch.signatures_sparse(torch.tensor(idx), torch.tensor(pi), k)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", PACK_BITS)
@pytest.mark.parametrize("d,k", [(4096, 64), ((1 << 16) + 3, 40)])
def test_fused_pack_matches_reference(b, d, k):
    idx, sigma, pi = _case(5, 23, d, seed=b)
    want = np.asarray(ref_dispatch.signatures_sparse(
        jnp.asarray(idx), jnp.asarray(pi), k, jnp.asarray(sigma),
        impl="windows", pack_b=b))
    got = _port(idx, sigma, pi, k, pack_b=b)
    assert np.array_equal(u32_to_host(got), want)


def test_window_helpers_match_reference():
    rng = np.random.default_rng(0)
    d, wl = 100, 16
    pi = rng.permutation(d).astype(np.int32)
    want = np.asarray(ref_sparse.window_table(jnp.asarray(pi), wl))
    got = t_sparse.window_table(torch.tensor(pi), wl)
    assert np.array_equal(got.numpy(), want)
    idx = rng.integers(-1, d, (4, 9), dtype=np.int32)
    for off in (0, 1):
        want = np.asarray(ref_sparse.window_starts(
            jnp.asarray(idx), d, wl, shift_offset=off))
        got = t_sparse.window_starts(torch.tensor(idx), d, wl,
                                     shift_offset=off)
        assert np.array_equal(got.numpy(), want)
    assert t_sparse.invalid_start(d, wl) == ref_sparse.invalid_start(d, wl)


@pytest.mark.parametrize("pack_b", [None, 8])
def test_plain_version_matches_pallas_kernel_interpret(pack_b):
    """The Pallas kernel itself, in interpret mode, at B <= 4."""
    idx, sigma, pi = _case(3, 11, 512, seed=5)
    sidx = np.asarray(apply_permutation_sparse(jnp.asarray(idx),
                                               jnp.asarray(sigma)))
    want = np.asarray(ref_sparse.cminhash_sparse_pallas(
        jnp.asarray(sidx), jnp.asarray(pi), 32, block_b=2, block_j=4,
        interpret=True, pack_b=pack_b))
    got = t_sparse.cminhash_sparse_kernel(torch.tensor(sidx),
                                          torch.tensor(pi), 32,
                                          pack_b=pack_b)
    got = got.numpy() if pack_b is None else u32_to_host(got)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pack_b", [None, 4, 32])
def test_engine_sign_with_carried_permutations(pack_b):
    d, k = 2048, 64
    ref = RefSketchEngine(RefSketchConfig(d=d, k=k, seed=3))
    params = convert.permutations_from_jax(np.asarray(ref.sigma),
                                           np.asarray(ref.pi), "cpu")
    eng = SketchEngine(SketchConfig(d=d, k=k, seed=3), device="cpu",
                       params=params)
    idx, _, _ = _case(7, 19, d, seed=11)
    want = np.asarray(ref.sign(jnp.asarray(idx), layout="sparse",
                               pack_b=pack_b))
    got = eng.sign(idx, layout="sparse", pack_b=pack_b)
    got = got.numpy() if pack_b is None else u32_to_host(got)
    assert np.array_equal(got, want)
    assert eng.parameter_bytes == ref.parameter_bytes


def test_wrapper_validates_its_inputs():
    pi = torch.arange(64, dtype=torch.int32)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="shift_offset"):
        t_sparse.cminhash_sparse_kernel(idx, pi, 8, shift_offset=2)
    with pytest.raises(ValueError, match="K <= D"):
        t_sparse.cminhash_sparse_kernel(idx, pi, 65)
    with pytest.raises(ValueError, match="b must be"):
        t_sparse.cminhash_sparse_kernel(idx, pi, 8, pack_b=3)
