"""The selective-scan kernel's CPU side (``kernels/ssm_scan.py``) and
``ssm_block``'s choice between it and the chunked scan.

On the CPU: the plain version (a float32 loop over the positions, the
kernel's arithmetic) against the port's ``_ssm_inner`` and the JAX
package's, at float32 and bf16 inputs, S of 1, below and past a chunk,
non-zero h0 and N of 8 and 16; the rule that splits a channel's states
over lanes; the dispatch rule, which keeps CPU tensors, a gradient and a
bf16 scan on ``_ssm_inner``; the wrapper's refusals; the kernel in
``all_kernels()`` and ``_build.SOURCES``.  The kernel against its plain
version on a card is in ``tests/test_torch_cuda.py``.

Tolerance 1e-5 of the largest |value| (observed ~3e-7): the chunked scans
multiply the decays into running products in another order than one
position at a time, and float32 rounds each order differently.  bf16
inputs are widened the same way on every side, so the tolerance holds.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build, all_kernels
from repro_torch.kernels import ssm_scan as ks
from repro_torch.models import ssm as t_ssm

TOL = 1e-5


def _operands(b, s, di, n, dtype=torch.float32, seed=0):
    """(dt, a, B, C, x, h0) as ``ssm_block`` makes them: dt a softplus
    around the init's 0.01, a = -(1 .. N) per channel, h0 non-zero."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(-4.6, 0.5, (b, s, di))))
    a = -np.exp(rng.normal(0, 0.3, (di, n))) * np.arange(1, n + 1)
    bm, cm = rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n))
    xs, h0 = rng.normal(size=(b, s, di)), rng.normal(size=(b, di, n))
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return (f(dt), f(a), f(bm).to(dtype), f(cm).to(dtype), f(xs).to(dtype),
            f(h0))


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


SHAPES = [(2, 1, 12, 8), (2, 13, 12, 8), (3, 40, 20, 16), (1, 70, 33, 16)]


@pytest.mark.parametrize("b,s,di,n", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_ssm_inner_and_the_reference(b, s, di, n, dtype):
    ops = _operands(b, s, di, n, dtype, seed=s + n)
    y, h = ks.ssm_scan_plain(*ops)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (b, s, di) and h.shape == (b, di, n)
    ty, th = t_ssm._ssm_inner(*ops, 16, torch.float32)
    ry, rh = ref_ssm._ssm_inner(*(jnp.asarray(t.float().numpy())
                                  for t in ops), 16, jnp.float32)
    assert _err(y, ty) < TOL and _err(h, th) < TOL
    assert _err(y, ry) < TOL and _err(h, rh) < TOL


def test_plain_from_zero_positions_keeps_h0():
    ops = _operands(2, 1, 12, 8)
    ops = (ops[0][:, :0], ops[1], ops[2][:, :0], ops[3][:, :0],
           ops[4][:, :0], ops[5])
    y, h = ks.ssm_scan_plain(*ops)
    assert y.shape == (2, 0, 12) and torch.equal(h, ops[5])


@pytest.mark.parametrize("batch,d_inner,lanes", [
    (16, 8192, 1), (3, 8192, 2), (2, 8192, 4), (1, 8192, 4),
    (1, 128, 4), (64, 1600, 1)])
def test_lanes_split_a_channel_only_where_blocks_are_few(batch, d_inner,
                                                         lanes):
    assert ks.scan_lanes(batch, d_inner, 132) == lanes


def _card_like(requires_grad=False):
    """A stand-in operand that reports a CUDA device."""
    return SimpleNamespace(device=torch.device("cuda"),
                           requires_grad=requires_grad)


@pytest.mark.parametrize("scan_dtype,grad_on,needs_grad,want", [
    ("float32", True, False, True), ("float32", False, True, True),
    ("float32", True, True, False), ("bfloat16", False, False, False)])
def test_dispatch_rule_on_a_card(scan_dtype, grad_on, needs_grad, want):
    cfg = SimpleNamespace(ssm_scan_dtype=scan_dtype)
    with torch.set_grad_enabled(grad_on):
        assert t_ssm._scan_on_kernel(
            cfg, _card_like(), _card_like(needs_grad)) is want


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad", [False, True])
def test_ssm_block_on_the_cpu_keeps_the_chunked_scan(monkeypatch,
                                                     scan_dtype, grad):
    cfg = dataclasses.replace(reduced(get_config("falcon_mamba_7b"),
                                      d_model=32),
                              dtype="float32", ssm_scan_dtype=scan_dtype)
    gen = torch.Generator().manual_seed(0)
    p = t_ssm.init_ssm(gen, cfg, torch.float32)
    if grad:
        p = {k: v.requires_grad_() for k, v in p.items()}
    calls = []
    inner = t_ssm._ssm_inner
    monkeypatch.setattr(t_ssm, "_ssm_inner",
                        lambda *a: calls.append(a) or inner(*a))
    monkeypatch.setattr(ks, "ssm_scan_kernel", lambda *a: pytest.fail(
        "the CPU path reached the scan kernel"))
    x = torch.randn(2, 9, cfg.d_model, generator=gen)
    with torch.set_grad_enabled(grad):
        y, h, _ = t_ssm.ssm_block(p, x, cfg)
    assert len(calls) == 1 and calls[0][-1] == getattr(torch, scan_dtype)
    assert y.requires_grad is grad


def test_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA device"):
        ks.ssm_scan_kernel(*_operands(2, 5, 12, 16))


@pytest.mark.parametrize("n", [4, 12, 32])
def test_wrapper_refuses_an_unbuilt_n(n):
    with pytest.raises(ValueError, match=r"N in \(8, 16\)"):
        ks.ssm_scan_kernel(*_operands(2, 5, 12, n))


@pytest.mark.parametrize("which,dtype,match", [
    (0, torch.bfloat16, "dt must be torch.float32"),
    (1, torch.float64, "a must be torch.float32"),
    (5, torch.bfloat16, "h0 must be torch.float32"),
    (2, torch.bfloat16, "bmat must be xs's dtype"),
    (3, torch.float16, "cmat must be xs's dtype")])
def test_wrapper_refuses_a_wrong_dtype(which, dtype, match):
    ops = list(_operands(2, 5, 12, 16))
    ops[which] = ops[which].to(dtype)
    with pytest.raises(TypeError, match=match):
        ks.ssm_scan_kernel(*ops)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float16])
def test_wrapper_refuses_an_unbuilt_x_dtype(dtype):
    ops = list(_operands(2, 5, 12, 16))
    ops[2:5] = [t.to(dtype) for t in ops[2:5]]
    with pytest.raises(TypeError, match="xs must be one of"):
        ks.ssm_scan_kernel(*ops)


@pytest.mark.parametrize("which,shape,match", [
    (1, (13, 16), "a must be of shape"),
    (2, (2, 4, 16), "bmat must be of shape"),
    (3, (2, 5, 8), "cmat must be of shape"),
    (4, (1, 5, 12), "xs must be of shape"),
    (5, (2, 12, 8), "h0 must be of shape"),
    (0, (10, 12), "dt must be")])
def test_wrapper_refuses_a_wrong_shape(which, shape, match):
    ops = list(_operands(2, 5, 12, 16))
    ops[which] = torch.zeros(shape, dtype=ops[which].dtype)
    with pytest.raises(ValueError, match=match):
        ks.ssm_scan_kernel(*ops)


def test_the_kernel_is_listed_and_built():
    assert all_kernels()["ssm_scan"] is ks.KERNEL
    assert "ssm_scan" in _build.SOURCES
    assert (_build.CSRC / "ssm_scan.cu").is_file()
