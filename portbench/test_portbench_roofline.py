"""The yardstick's counts, the trace arithmetic and the device-trace
readers on hand-computed cases."""

import pytest

from portbench import devtrace, harness, roofline

PEAK = {"int32_ops_per_s": 1e12, "bytes_per_s": 1e11, "source": "test"}


def test_h100_peaks_state_their_rates():
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert p["int32_ops_per_s"] == pytest.approx(16.72704e12)
    assert p["bytes_per_s"] == 3.35e12
    assert roofline.peaks("NVIDIA H100 PCIe") is None


@pytest.mark.parametrize("k, b, words", [(256, 32, 256), (256, 16, 128),
                                         (256, 8, 64), (33, 2, 3)])
def test_words_per_row(k, b, words):
    assert roofline.words_per_row(k, b) == words


def test_collision_work_counts_real_rows_words_and_the_counts_written():
    ops, n_bytes = roofline.collision_work(rows=3, index_rows=5, k=4, b=32)
    assert ops == 3 * 5 * 4
    assert n_bytes == 4 * (3 * 4 + 5 * 4 + 3 * 5)
    # at b = 8 a word holds four codes: one compare a word pair
    ops8, bytes8 = roofline.collision_work(rows=3, index_rows=5, k=8, b=8)
    assert ops8 == 3 * 5 * 2 and bytes8 == 4 * (3 * 2 + 5 * 2 + 15)


def test_sign_work_counts_k_reads_an_entry():
    ops, n_bytes = roofline.sign_work(entries=10, rows=2, d=16, k=4, b=32)
    assert ops == 40
    assert n_bytes == 4 * (10 + 16 + 2 * 4)


def test_least_time_is_the_larger_bound():
    assert roofline.least_s(2e12, 1e9, PEAK) == 2.0      # by operations
    assert roofline.least_s(1e9, 3e11, PEAK) == 3.0      # by bytes


OPS = [(0.0, 10.0, "a"), (5.0, 20.0, "b"), (30.0, 40.0, "a"),
       (45.0, 60.0, "c")]


def test_busy_is_the_union_of_intervals():
    assert devtrace.busy_us(OPS, 0.0, 50.0) == 20 + 10 + 5
    assert devtrace.busy_us(OPS, 8.0, 35.0) == 12 + 5


def test_gaps_and_time_by_name():
    assert devtrace.gaps_us(OPS, 0.0, 70.0) == [(20.0, 30.0), (40.0, 45.0),
                                                (60.0, 70.0)]
    assert devtrace.time_by_name(OPS) == {"a": 20.0, "b": 15.0, "c": 15.0}


def run_with(ops, work, profiled=(0.0, 100.0)):
    cfg = {"service": {"d": 16, "k": 4, "b": 32}}
    return harness.Run(config=cfg, setup_s=1.0,
                       window_s=1.0, latencies_s=[0.1], rows=1, steps=1,
                       failed=0, ops=ops, profiled=profiled, work=work,
                       peak=PEAK)


def test_collision_roofline_reads_the_fallback_rows():
    reader = harness.load_module(harness.BENCH, "metrics",
                                 "collision_roofline")
    work = [{"rows": 8, "entries": 40, "width": 6, "fallback_rows": 3,
             "index_rows": 1000}] * 2
    # per step: 3 x 1000 x 4 compares = 12,000 ops -> 12 ns; bytes 4 x
    # (12 + 4000 + 3000) = 28,048 -> 280.48 ns: by bytes
    ops = [(0.0, 1.0, "void collision_kernel<4>(unsigned)"),
           (2.0, 3.0, "void collision_kernel<4>(unsigned)"),
           (1.0, 2.0, "other")]
    assert reader.read(run_with(ops, work)) == pytest.approx(
        100 * 2 * 280.48e-9 / 2e-6)
    assert reader.read(run_with([(0.0, 1.0, "other")], work)) is None


def test_sign_roofline_reads_the_real_entries():
    reader = harness.load_module(harness.BENCH, "metrics", "sign_roofline")
    work = [{"rows": 2, "entries": 10, "width": 8, "fallback_rows": 0,
             "index_rows": 5}]
    ops = [(0.0, 4.0, "void cminhash_sparse_kernel<8, 0>(int const*)")]
    # 40 reads -> 40 ps; 4 x (10 + 16 + 8) = 136 bytes -> 1.36 ns
    assert reader.read(run_with(ops, work)) == pytest.approx(
        100 * 1.36e-9 / 4e-6)


def test_device_idle_share():
    reader = harness.load_module(harness.BENCH, "metrics", "device_idle_pct")
    assert reader.read(run_with(OPS, [], profiled=(0.0, 70.0))) == \
        pytest.approx(100 * (1 - 45 / 70))
    assert reader.read(run_with([], [], profiled=None)) is None


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch.store", "numpy",
                                      "reprox"]) == []
    assert harness.forbidden_modules(["repro.core.lsh", "jaxlib.xla",
                                      "flax", "repro_torch"]) == \
        ["flax", "jaxlib", "repro"]
