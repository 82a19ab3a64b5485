"""The port's cost analysis and roofline (``repro_torch.analysis``) against
the reference's (``repro.analysis``), on the CPU.

``hlo.analyze`` traces a PyTorch program and counts as the reference's
analyzer counts compiled HLO: the same FLOPs and bytes for the same
product, every trip of a loop, the ring formulas for the port's
collectives.  The roofline's formulas are the reference's (held with the
reference's constants patched in); its constants are the H100's, and
``cminhash_kernel_roofline`` gives the bounds ``chip_smoke.py`` prints
for the dense signing kernels.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import compare as ref_compare
from repro.analysis import hlo as ref_hlo
from repro.analysis import roofline as ref_roofline
from repro_torch.analysis import compare, hlo, roofline
from repro_torch.distributed import collectives as col

META = torch.device("meta")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(*shape):
    return torch.empty(shape, device=META)


@pytest.mark.parametrize("m,k,n", [(128, 256, 64), (7, 33, 5),
                                   (512, 1024, 2048)])
def test_analyze_matches_the_reference_on_a_product(m, k, n):
    """tanh(x @ w): the port's count of the trace within 2% of the
    reference's count of the compiled HLO (equal, in fact)."""
    got = hlo.analyze(lambda x, w: torch.tanh(x @ w), _meta(m, k),
                      _meta(k, n))
    f = jax.jit(lambda x, w: jnp.tanh(x @ w))
    text = f.lower(jnp.zeros((m, k)), jnp.zeros((k, n))).compile().as_text()
    want = ref_hlo.analyze(text)
    assert got.flops == pytest.approx(want.flops, rel=0.02)
    assert got.flops == 2 * m * k * n + m * n
    assert got.bytes == pytest.approx(want.bytes, rel=0.02)
    assert got.collective_bytes == 0 and got.n_collectives == 0


def test_analyze_charges_a_slice_as_the_reference():
    """A slice is a view in PyTorch and a copy in the reference's HLO: the
    fused bytes charge it as the reference does (2 x its output)."""
    got = hlo.analyze(lambda x: torch.tanh(x[:, 3:67] * 2), _meta(64, 128))
    f = jax.jit(lambda x: jnp.tanh(x[:, 3:67] * 2))
    want = ref_hlo.analyze(f.lower(jnp.zeros((64, 128))).compile().as_text())
    assert (got.flops, got.bytes) == (want.flops, want.bytes)


def test_analyze_counts_every_trip_of_a_layer_loop():
    """A Python loop over L layers is traced once a trip: L x one layer's
    FLOPs (what the reference's scan multipliers restore)."""
    def layer(x, w):
        return torch.tanh(x @ w) * 2.0

    def model(x, ws):
        for w in ws:
            x = layer(x, w)
        return x

    one = hlo.analyze(layer, _meta(64, 128), _meta(128, 128))
    for n_layers in (1, 3, 8):
        got = hlo.analyze(model, _meta(64, 128),
                          [_meta(128, 128) for _ in range(n_layers)])
        assert got.flops == n_layers * one.flops
        assert got.bytes_naive == n_layers * one.bytes_naive


def test_analyze_real_tensors_and_autograd():
    """On real CPU tensors the trace computes as well: a backward pass
    counts its products (twice the forward's: the gradients of x and of
    w), and the answer is unchanged."""
    x = torch.randn(16, 32, requires_grad=True)
    w = torch.randn(32, 8, requires_grad=True)

    def step(x, w):
        loss = (x @ w).square().sum()
        loss.backward()
        return loss

    got = hlo.analyze(step, x, w)
    products = 3 * 2 * 16 * 32 * 8
    assert products < got.flops < products + 16 * 8 * 8
    y = x.detach() @ w.detach()
    assert torch.allclose(w.grad, 2 * x.detach().t() @ y)
    assert torch.allclose(x.grad, 2 * y @ w.detach().t())


def test_analyze_peak_temp_bytes_is_the_most_live_at_once():
    """``peak_temp_bytes`` is the most bytes the program's own operations
    held at once: a tensor counts from the operation that made it until
    its last reference goes, the arguments and an in-place update count
    nothing, and a tree built before the trace is not step work."""
    def step(x):
        a = x * 2                     # a: 4,000
        b = a + 1                     # a, b: 8,000
        del a                         # b: 4,000
        b.add_(1)                     # in place: nothing new
        c = torch.cat([b, b])         # b, c: 12,000
        del b
        return c.sum()                # c and the sum: 8,004

    got = hlo.analyze(step, _meta(1000))
    assert got.peak_temp_bytes == 12_000
    # the same step beside a large tree made before the trace
    tree = [_meta(10_000) for _ in range(4)]
    assert hlo.analyze(lambda x, t: step(x), _meta(1000),
                       tree).peak_temp_bytes == 12_000


@pytest.fixture
def fake_group():
    """This process as rank 0 of a fake group (its collectives move
    nothing), torn down after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    try:
        yield init
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("data,model", [(1, 2), (2, 4), (1, 16), (4, 8)])
def test_collective_bytes_are_the_ring_formulas(fake_group, data, model):
    """Each wrapper call over a group of g ranks: all-reduce 2 (g-1)/g x
    size, all-gather (g-1)/g x the gathered output, reduce-scatter
    (g-1)/g x the input; over a tuple of axes, one call an axis."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_group(data * model)
    mesh = init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))
    t = torch.empty(64, 32, dtype=torch.bfloat16, device=META)
    size = 64 * 32 * 2
    g = model

    def run(t):
        col.all_reduce(t, mesh, "model")
        col.all_gather(t, mesh, "model", 0)
        col.reduce_scatter(t, mesh, "model", 0)
        col.all_reduce(t, mesh, ("data", "model"))
        return t

    got = hlo.analyze(run, t)
    ar = 2 * (g - 1) / g * size
    ag = (g - 1) / g * size * g
    rs = (g - 1) / g * size
    ar_data = 2 * (data - 1) / data * size if data > 1 else 0.0
    assert got.collective_breakdown == pytest.approx(
        {"all-reduce": 2 * ar + ar_data, "all-gather": ag,
         "reduce-scatter": rs})
    assert got.collective_bytes == pytest.approx(2 * ar + ar_data + ag + rs)
    assert got.n_collectives == 4 + (data > 1)
    assert got.collective_bytes == hlo.wire_bytes("all_reduce", size, g) \
        * 2 + hlo.wire_bytes("all_reduce", size, data) \
        + hlo.wire_bytes("all_gather", size, g) \
        + hlo.wire_bytes("reduce_scatter", size, g)


def _fake_record(kind="train", flops=1e12, bytes_=1e11, coll=1e9,
                 arch="x", shape="train_4k", mesh="single_pod"):
    """The reference test's record (``tests/test_serve_analysis.py``)."""
    return {
        "arch": arch, "shape": shape, "mesh": mesh,
        "n_chips": 256, "seq_len": 4096, "global_batch": 256, "kind": kind,
        "params": int(1e9), "active_params": int(1e9), "status": "ok",
        "compile_s": 1.0,
        "memory": {"argument_bytes": 1e9, "output_bytes": 1, "temp_bytes": 1,
                   "alias_bytes": 1, "code_bytes": 0},
        "xla_cost": {"flops": flops / 10, "bytes accessed": bytes_ / 10},
        "hlo_cost": {"flops": flops, "bytes": bytes_, "bytes_naive": bytes_,
                     "collective_bytes": coll, "collective_breakdown": {},
                     "n_collectives": 3},
    }


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's roofline with the reference's (TPU v5e) constants."""
    monkeypatch.setattr(roofline, "PEAK_FLOPS", ref_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", ref_roofline.ICI_BW)
    monkeypatch.setattr(roofline, "HBM_PER_CHIP", ref_roofline.HBM_PER_CHIP)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("flops,bytes_,coll", [
    (1.97e14, 8.19e11, 5e10), (1e12, 1e14, 1e9), (1e12, 1e11, 1e13),
    (0.0, 1e11, 1e9)])
def test_roofline_equals_the_reference(reference_constants, kind, flops,
                                       bytes_, coll):
    rec = _fake_record(kind, flops, bytes_, coll)
    assert roofline.model_flops(rec) == ref_roofline.model_flops(rec)
    assert roofline.roofline(rec) == ref_roofline.roofline(rec)


def test_model_flops_kinds():
    rec = _fake_record()
    assert roofline.model_flops(rec) == 6 * 1e9 * 256 * 4096
    rec["kind"] = "prefill"
    assert roofline.model_flops(rec) == 2 * 1e9 * 256 * 4096
    rec["kind"] = "decode"
    assert roofline.model_flops(rec) == 2 * 1e9 * 256


def test_roofline_terms_on_the_h100():
    r = roofline.roofline(_fake_record(flops=989.4e12, bytes_=3.35e12,
                                       coll=50e9))
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(1.0)
    assert r["collective_s"] == pytest.approx(1.0)
    assert roofline.HBM_PER_CHIP == 80e9 and roofline.NVLINK_BW == 450e9
    assert roofline.INT32_OPS == 132 * 64 * 1.98e9


def _write(d, recs):
    d.mkdir()
    for r in recs:
        (d / f"{r['mesh']}__{r['arch']}__{r['shape']}.json").write_text(
            json.dumps(r))


def test_report_and_compare_equal_the_reference(reference_constants,
                                                tmp_path):
    """The markdown report and the sweep comparison, over the same record
    files, print the reference's text to the character."""
    skipped = dict(_fake_record(arch="y"), status="skipped",
                   reason="skipped: no")
    error = dict(_fake_record(arch="z"), status="error",
                 error="RuntimeError: " + "x" * 100)
    base = [_fake_record(), _fake_record("decode", arch="w",
                                         shape="decode_32k"),
            skipped, error, _fake_record(mesh="multi_pod")]
    opt = [_fake_record(flops=5e11), _fake_record(
        "decode", 1e12, 2e11, arch="w", shape="decode_32k"),
        skipped, error, _fake_record(mesh="multi_pod")]
    _write(tmp_path / "a", base)
    _write(tmp_path / "b", opt)
    out = {}
    for mesh in ("single_pod", "multi_pod"):
        md = roofline.report_markdown(str(tmp_path / "a"), mesh)
        assert md == ref_roofline.report_markdown(str(tmp_path / "a"), mesh)
        got = compare.compare(str(tmp_path / "a"), str(tmp_path / "b"), mesh)
        assert got == ref_compare.compare(str(tmp_path / "a"),
                                          str(tmp_path / "b"), mesh)
        out[mesh] = md, got
    md, got = out["single_pod"]
    assert "### Roofline" in md and "| x | train_4k |" in md
    assert "| w | decode_32k |" in got
    for x in (0.5, 2e-3, 3e-6, 1.0, 1234.5):
        assert roofline._fmt_s(x) == ref_roofline._fmt_s(x)


def _image_a_set_bits() -> int:
    """Set bits of Fig. 7's imageA corpus (4096 x 2048), drawn as
    ``chip_smoke.py``'s paper path draws it."""
    from repro_torch.data.synthetic import (imagelike_binary_dataset,
                                            textlike_binary_dataset)
    rng = np.random.default_rng(0)
    textlike_binary_dataset(rng, 4096, 2048, mean_nnz=80)
    textlike_binary_dataset(rng, 4096, 2048, mean_nnz=250)
    return int(imagelike_binary_dataset(rng, 4096, 2048, block=16).sum())


def test_kernel_roofline_reproduces_the_dense_kernels_bounds():
    """PERF.md's bounds for the dense signing kernels (kernel 5, int8 rows;
    kernel 6, bit-packed): 0.0927 ms by operations at imageA's 4096 x 2048,
    K = 512 (0.0923 packed), 0.0815 ms by bytes at the service's 4096 x
    2^16, K = 256, b = 32 (256 words a row)."""
    nnz = _image_a_set_bits() / 4096
    int8 = roofline.cminhash_kernel_roofline(4096, 2048, 512, nnz=nnz)
    packed = roofline.cminhash_kernel_roofline(4096, 2048, 512, nnz=nnz,
                                               packed=True)
    assert (round(int8["bound_s"] * 1e3, 4), int8["bound_by"]) == \
        (0.0927, "operations")
    assert (round(packed["bound_s"] * 1e3, 4), packed["bound_by"]) == \
        (0.0923, "operations")
    served = roofline.cminhash_kernel_roofline(4096, 1 << 16, 256, nnz=254,
                                               n_out=256)
    assert (round(served["bound_s"] * 1e3, 4), served["bound_by"]) == \
        (0.0815, "bytes")
    assert served["bytes"] == 4096 * 65536 + 65536 * 4 + 4096 * 256 * 4


def test_kernel_roofline_packing_helps_memory():
    a = roofline.cminhash_kernel_roofline(1024, 65536, 1024, packed=False)
    b = roofline.cminhash_kernel_roofline(1024, 65536, 1024, packed=True)
    assert b["bytes"] < a["bytes"] / 2
    assert b["ops"] < a["ops"]          # the scan: a word, not a byte
    assert b["arith_intensity"] > a["arith_intensity"]


def test_chip_smoke_bounds_come_from_the_roofline(monkeypatch):
    """``chip_smoke.py``'s kernel bounds are ``roofline.kernel_bound``'s, to
    the last digit."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    assert chip_smoke.HBM_BYTES_PER_S == roofline.HBM_BW
    assert chip_smoke.INT32_OPS_PER_S == roofline.INT32_OPS
    for n_bytes, n_ops in ((272_891_904, 1e6), (1e6, 4.29e9), (0, 0),
                           (38_010_880, 2.63e8)):
        ms, by = chip_smoke.bound_ms(n_bytes, n_ops)
        s, by2 = roofline.kernel_bound(n_bytes, n_ops)
        assert (ms, by) == (s * 1e3, by2)
        old = (n_bytes / 3.35e12 * 1e3, n_ops / (132 * 64 * 1.98e9) * 1e3)
        assert ms == max(old)
    sys.modules.pop("chip_smoke", None)
