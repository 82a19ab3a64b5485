"""The port's hashed-feature trainer against the JAX package's, on the CPU.

The same signatures (the reference engine's) and labels go through
``repro.core.linear_model`` (a jitted scan over the one-hot matrix) and
``repro_torch.core.linear_model`` (a gather of the weights the codes pick,
autograd, the reference's Adam update).  The two sum in other orders, so
the trainer is held within stated tolerances, set from the maxima observed
over these cases (``python tests/test_torch_linear.py`` prints them):

  * converged fits (300 steps): |w_port - w_ref| <= 1e-3 (observed 2.8e-5);
  * 50-step fits: <= 1e-2 (observed 3.2e-3 at b >= 4: a feature whose
    gradient hovers near zero takes Adam steps of up to lr * g / eps, so
    rounding in g moves w; 300 steps settle it again);
  * probabilities within 1e-3 (observed 1.3e-6), equal test accuracy;
  * ``predict_logistic`` on the reference's own weights (carried across by
    ``logistic_from_jax``) within 1e-6 (observed 1.9e-9), equal accuracy.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bbit as ref_bbit
from repro.core import linear_model as ref_lm
from repro.core.engine import SketchConfig, SketchEngine
from repro_torch import convert
from repro_torch.core import bbit as t_bbit
from repro_torch.core import linear_model as t_lm

ROOT = Path(__file__).resolve().parent.parent


def _data(rng, n, d, templates, flip=0.02):
    t0, t1 = templates
    y = rng.integers(0, 2, n)
    x = np.where(y[:, None] == 0, t0, t1) ^ (rng.random((n, d)) < flip)
    return x.astype(np.int8), y.astype(np.int32)


def _classifier_data():
    """test_linear_model.py's data: two 5%-density templates, 2% flips,
    D = 1024, K = 128, signed by the reference engine."""
    rng = np.random.default_rng(0)
    d, k = 1024, 128
    templates = (rng.random(d) < 0.05, rng.random(d) < 0.05)
    x_tr, y_tr = _data(rng, 256, d, templates)
    x_te, y_te = _data(rng, 128, d, templates)
    eng = SketchEngine(SketchConfig(d=d, k=k, seed=3))
    s_tr = np.array(eng.signatures_dense(jnp.asarray(x_tr)))
    s_te = np.array(eng.signatures_dense(jnp.asarray(x_te)))
    return s_tr, y_tr, s_te, y_te


@pytest.fixture(scope="module")
def classifier_data():
    return _classifier_data()


def _fit_both(s_tr, y_tr, b, steps):
    want = ref_lm.fit_logistic(jnp.asarray(s_tr), jnp.asarray(y_tr),
                               ref_lm.HashedLinearConfig(b=b, steps=steps))
    got = t_lm.fit_logistic(torch.from_numpy(s_tr), torch.from_numpy(y_tr),
                            t_lm.HashedLinearConfig(b=b, steps=steps))
    return got, want


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("steps,w_tol", [(300, 1e-3), (50, 1e-2)])
def test_fit_predict_accuracy_match_reference(classifier_data, b, steps,
                                              w_tol):
    s_tr, y_tr, s_te, y_te = classifier_data
    (w, bias), (rw, rbias) = _fit_both(s_tr, y_tr, b, steps)
    assert w.dtype == bias.dtype == torch.float32
    assert w.shape == (s_tr.shape[1] << b,) and bias.shape == ()
    assert np.abs(w.numpy() - np.asarray(rw)).max() <= w_tol
    assert abs(float(bias) - float(rbias)) <= w_tol
    p = t_lm.predict_logistic((w, bias), torch.from_numpy(s_te), b)
    rp = ref_lm.predict_logistic((rw, rbias), jnp.asarray(s_te), b)
    assert p.dtype == torch.float32 and p.shape == (len(s_te),)
    assert np.abs(p.numpy() - np.asarray(rp)).max() <= 1e-3
    acc = t_lm.accuracy((w, bias), torch.from_numpy(s_te),
                        torch.from_numpy(y_te), b)
    assert acc == ref_lm.accuracy((rw, rbias), jnp.asarray(s_te),
                                  jnp.asarray(y_te), b)
    if steps == 300 and b in (1, 4):        # test_linear_model.py's bound
        assert acc > 0.95


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_predict_on_the_reference_weights(classifier_data, b):
    s_tr, y_tr, s_te, y_te = classifier_data
    rwb = ref_lm.fit_logistic(jnp.asarray(s_tr), jnp.asarray(y_tr),
                              ref_lm.HashedLinearConfig(b=b))
    wb = convert.logistic_from_jax(tuple(np.asarray(a) for a in rwb), "cpu")
    p = t_lm.predict_logistic(wb, torch.from_numpy(s_te), b)
    rp = ref_lm.predict_logistic(rwb, jnp.asarray(s_te), b)
    assert np.abs(p.numpy() - np.asarray(rp)).max() <= 1e-6
    assert t_lm.accuracy(wb, torch.from_numpy(s_te), torch.from_numpy(y_te),
                         b) == ref_lm.accuracy(rwb, jnp.asarray(s_te),
                                               jnp.asarray(y_te), b)


def test_predict_probabilities_bounded_like_reference():
    """test_linear_model.py's second case: random codes, b = 2, 50 steps."""
    rng = np.random.default_rng(1)
    sigs = rng.integers(0, 100, (16, 32)).astype(np.int32)
    y = rng.integers(0, 2, 16).astype(np.int32)
    (w, bias), (rw, rbias) = _fit_both(sigs, y, 2, 50)
    assert np.abs(w.numpy() - np.asarray(rw)).max() <= 1e-3
    p = t_lm.predict_logistic((w, bias), torch.from_numpy(sigs), 2)
    assert float(p.min()) >= 0.0 and float(p.max()) <= 1.0
    rp = ref_lm.predict_logistic((rw, rbias), jnp.asarray(sigs), 2)
    assert np.abs(p.numpy() - np.asarray(rp)).max() <= 1e-3


@pytest.mark.parametrize("b", [1, 3, 8])
def test_gathered_logits_equal_the_one_hot_product(b):
    """The gather picks exactly the one-hot matrix's columns: logits from
    ``code_index`` equal ``bbit_features(sigs, b) @ w`` (the reference's
    feature map), here in float64 where both sums are exact enough to
    compare at 1e-12."""
    rng = np.random.default_rng(b)
    sigs = rng.integers(-2**31, 2**31 - 1, (40, 24)).astype(np.int32)
    w = torch.from_numpy(rng.standard_normal(24 << b))
    codes = t_lm.code_index(torch.from_numpy(sigs), b)
    assert codes.shape == (24, 40) and codes.dtype == torch.int64
    onehot = t_bbit.bbit_features(torch.from_numpy(sigs), b).double()
    ref_onehot = np.asarray(ref_bbit.bbit_features(jnp.asarray(sigs), b))
    assert np.array_equal(onehot.numpy(), ref_onehot)
    cols = (torch.arange(24)[:, None] << b) + codes
    assert torch.equal(onehot.nonzero()[:, 1].view(40, 24), cols.T)
    bias = torch.tensor(0.25, dtype=torch.float64)
    assert torch.allclose(t_lm._logits(w, bias, codes), onehot @ w + bias,
                          rtol=0, atol=1e-12)


def test_logistic_from_jax_refuses_other_shapes():
    with pytest.raises(ValueError, match="wb must be"):
        convert.logistic_from_jax((np.zeros((2, 2)), np.zeros(())), "cpu")
    w, bias = convert.logistic_from_jax((np.ones(4), np.float32(2)), "cpu")
    assert w.dtype == bias.dtype == torch.float32 and float(bias) == 2.0


def test_classifier_example_on_the_cpu():
    out = subprocess.run(
        [sys.executable,
         str(ROOT / "examples" / "hash_features_classifier_torch.py"),
         "--device", "cpu", "--train", "300", "--test", "200"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    accs = [float(ln.split()[-1]) for ln in out.stdout.splitlines()
            if ln.split() and ln.split()[0] in ("1", "2", "4", "8")]
    assert len(accs) == 4 and min(accs) > 0.95, out.stdout


def drift() -> None:
    """Print the largest port-vs-reference differences over this file's
    fits, the maxima the tolerances above were set from."""
    s_tr, y_tr, s_te, y_te = _classifier_data()
    for steps in (300, 50):
        for b in (1, 2, 4, 8):
            (w, bias), (rw, rbias) = _fit_both(s_tr, y_tr, b, steps)
            p = t_lm.predict_logistic((w, bias), torch.from_numpy(s_te), b)
            rp = np.asarray(ref_lm.predict_logistic((rw, rbias),
                                                    jnp.asarray(s_te), b))
            rw_port = convert.logistic_from_jax(
                (np.asarray(rw), np.asarray(rbias)), "cpu")
            p_same = t_lm.predict_logistic(rw_port, torch.from_numpy(s_te), b)
            print(f"steps {steps} b {b}: |dw| "
                  f"{np.abs(w.numpy() - np.asarray(rw)).max():.2e}, |dbias| "
                  f"{abs(float(bias) - float(rbias)):.2e}, |dp| "
                  f"{np.abs(p.numpy() - rp).max():.2e}, |dp| on the "
                  f"reference's weights {np.abs(p_same.numpy() - rp).max():.2e}")


if __name__ == "__main__":
    drift()
