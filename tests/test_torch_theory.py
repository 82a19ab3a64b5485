"""The port's theory module against the JAX package's, tolerance 0.

``repro_torch.core.theory`` is a numpy/scipy copy of ``repro.core.theory``:
every public function must give exactly the reference's value over
``tests/test_theory.py``'s grid, ``etilde_mc`` included under the same
seed (the same numpy generator, the same draws, the same float sums).
Also the Fig. 6 example, on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import theory as ref
from repro_torch.core import theory as port

ROOT = Path(__file__).resolve().parent.parent

PUBLIC = ("location_vector", "af_counts", "structured_location_vector",
          "pair_set_sizes", "theta_from_sizes", "var_minhash", "var_0pi",
          "etilde_exact", "etilde_mc", "var_sigma_pi", "variance_ratio")

# (D, f, a) cells of test_theory.py
CELLS = [(16, 8, 4), (24, 12, 3), (32, 20, 10), (40, 10, 5), (32, 16, 8),
         (24, 12, 6), (32, 16, 4), (10, 10, 4), (20, 10, 0), (20, 10, 10),
         (36, 15, 7), (30, 14, 3), (40, 21, 10)]


def test_constants_and_names_match():
    assert (port.SENT, port.O, port.X, port.N) == \
        (ref.SENT, ref.O, ref.X, ref.N)
    for name in PUBLIC:
        assert callable(getattr(port, name)), name


@pytest.mark.parametrize("seed", range(4))
def test_location_vectors_and_set_sizes(seed):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(5, 60))
    v = rng.random(d) < 0.4
    w = rng.random(d) < 0.4
    x = port.location_vector(v, w)
    assert x.dtype == np.int8
    assert np.array_equal(x, ref.location_vector(v, w))
    assert port.af_counts(x) == ref.af_counts(x)
    for delta in range(0, d + 2):
        assert port.pair_set_sizes(x, delta) == ref.pair_set_sizes(x, delta)


@pytest.mark.parametrize("d,f,a", CELLS)
def test_exact_functions_match(d, f, a):
    x = port.structured_location_vector(d, f, a)
    assert np.array_equal(x, ref.structured_location_vector(d, f, a))
    assert x.dtype == ref.structured_location_vector(d, f, a).dtype
    assert port.etilde_exact(d, f, a) == ref.etilde_exact(d, f, a)
    for k in sorted(k for k in {1, 8, 16, 24, d} if k <= d):
        assert port.var_0pi(x, k) == ref.var_0pi(x, k)
        assert port.var_sigma_pi(d, f, a, k, method="exact") == \
            ref.var_sigma_pi(d, f, a, k, method="exact")
        assert port.var_minhash(a / f, k) == ref.var_minhash(a / f, k)
        got = port.variance_ratio(d, f, a, k, method="exact")
        want = ref.variance_ratio(d, f, a, k, method="exact")
        assert got == want or (np.isinf(got) and np.isinf(want))
    if 0 < a < f:
        s = port.pair_set_sizes(x, 1)
        assert port.theta_from_sizes(s["l0"], s["l2"], s["g0"], s["g1"],
                                     a, f) == \
            ref.theta_from_sizes(s["l0"], s["l2"], s["g0"], s["g1"], a, f)


@pytest.mark.parametrize("d,f,a,seed,n", [
    (16, 8, 4, 1, 30_000), (40, 10, 5, 1, 20_000), (100, 50, 5, 0, 9_000),
    (100, 50, 45, 3, 5_000), (128, 64, 16, 0, 4_097), (20, 10, 0, 0, 10)])
def test_etilde_mc_draws_what_the_reference_draws(d, f, a, seed, n):
    assert port.etilde_mc(d, f, a, n_samples=n, seed=seed) == \
        ref.etilde_mc(d, f, a, n_samples=n, seed=seed)
    assert port.etilde_mc(d, f, a, n_samples=n, seed=seed, chunk=1000) == \
        ref.etilde_mc(d, f, a, n_samples=n, seed=seed, chunk=1000)


@pytest.mark.parametrize("d,f,a,k", [(100, 50, 25, 50), (64, 20, 5, 32),
                                     (30, 14, 3, 20)])
def test_var_sigma_pi_auto_and_mc_match(d, f, a, k):
    for kw in ({"method": "auto", "n_samples": 6000, "seed": 2},
               {"method": "mc", "n_samples": 5000, "seed": 7}):
        assert port.var_sigma_pi(d, f, a, k, **kw) == \
            ref.var_sigma_pi(d, f, a, k, **kw)
        assert port.variance_ratio(d, f, a, k, **kw) == \
            ref.variance_ratio(d, f, a, k, **kw)


def test_refusals_match():
    x = port.structured_location_vector(8, 4, 2)
    for call in (lambda m: m.var_0pi(x, 9),
                 lambda m: m.var_sigma_pi(8, 4, 2, 9),
                 lambda m: m.etilde_exact(8, 9, 2),
                 lambda m: m.etilde_exact(8, 4, 5)):
        with pytest.raises(ValueError) as e_ref:
            call(ref)
        with pytest.raises(ValueError) as e_port:
            call(port)
        assert str(e_port.value) == str(e_ref.value)


def test_variance_example_on_the_cpu():
    out = subprocess.run(
        [sys.executable,
         str(ROOT / "examples" / "variance_validation_torch.py"),
         "--device", "cpu", "--reps", "300"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "Theorem 3.4" in out.stdout
    assert len([ln for ln in out.stdout.splitlines() if " | " in ln]) == 5
