"""The PyTorch port's core pieces held bit for bit against the JAX package.

Packed-code format, host band hashing, sparse permutation, carrying the
reference's permutations across, the import rule (the port imports neither
jax nor repro) and the device rule (entry points run on the card unless the
caller asks for the CPU).
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as ref_lsh
from repro.core import permutations as ref_perm
from repro.kernels import packfmt as ref_packfmt
from repro_torch import convert, device as tdevice
from repro_torch.core import lsh as t_lsh
from repro_torch.core import permutations as t_perm
from repro_torch.kernels import packfmt as t_packfmt
from repro_torch.kernels.query_fused import hashes_to_host

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
CPU = torch.device("cpu")


@pytest.mark.parametrize("b", ref_packfmt.PACK_BITS)
@pytest.mark.parametrize("k", [1, 7, 33, 64, 70])
def test_pack_unpack_match_reference(b, k):
    rng = np.random.default_rng(b * 100 + k)
    sig = rng.integers(-2**31, 2**31, (5, k), dtype=np.int64).astype(np.int32)
    sig[0] = 2**31 - 1                           # SENTINEL rows
    want = np.asarray(ref_packfmt.pack_codes(jnp.asarray(sig), b))
    got = t_packfmt.pack_codes(torch.tensor(sig), b)
    assert got.dtype == torch.int32
    assert np.array_equal(tdevice.u32_to_host(got), want)
    want_codes = np.asarray(ref_packfmt.unpack_codes(jnp.asarray(want), k, b))
    got_codes = t_packfmt.unpack_codes(got, k, b)
    assert np.array_equal(got_codes.numpy(), want_codes)
    assert t_packfmt.pack_geometry(k, b) == ref_packfmt.pack_geometry(k, b)


def test_pack_geometry_rejects_bad_b():
    with pytest.raises(ValueError):
        t_packfmt.pack_geometry(64, 3)


@pytest.mark.parametrize("nb,r", [(8, 4), (5, 7), (1, 13), (16, 1)])
def test_band_hashes_match_reference_including_negative_codes(nb, r):
    rng = np.random.default_rng(nb + r)
    sig = rng.integers(-2**31, 2**31, (9, nb * r), dtype=np.int64) \
        .astype(np.int32)
    assert np.array_equal(t_lsh.band_hashes(sig, nb, r),
                          ref_lsh.band_hashes(sig, nb, r))
    rows = sig.reshape(9, nb, r).astype(np.uint64)
    assert np.array_equal(t_lsh._poly_fold(rows), ref_lsh._poly_fold(rows))
    words = rng.integers(0, 2**32, (9, nb * r), dtype=np.uint32)
    assert np.array_equal(t_lsh.band_hashes_packed(words, nb),
                          ref_lsh.band_hashes_packed(words, nb))


def test_band_hashes_packed_rejects_misaligned_bands():
    with pytest.raises(ValueError):
        t_lsh.band_hashes_packed(np.zeros((2, 10), np.uint32), 3)


def test_apply_permutation_sparse_matches_reference():
    rng = np.random.default_rng(3)
    d = 1000
    sigma = rng.permutation(d).astype(np.int32)
    idx = rng.integers(0, d, (6, 17), dtype=np.int32)
    idx[:, 5:9] = -1
    idx[2] = -1                                  # an all-padding row
    want = np.asarray(ref_perm.apply_permutation_sparse(
        jnp.asarray(idx), jnp.asarray(sigma)))
    got = t_perm.apply_permutation_sparse(torch.tensor(idx),
                                          torch.tensor(sigma))
    assert np.array_equal(got.numpy(), want)


def test_make_two_permutations_are_permutations():
    gen = torch.Generator().manual_seed(0)
    sigma, pi = t_perm.make_two_permutations(gen, 257, device="cpu")
    for p in (sigma, pi):
        assert p.dtype == torch.int32
        assert torch.equal(torch.sort(p).values,
                           torch.arange(257, dtype=torch.int32))
    assert not torch.equal(sigma, pi)


def test_permutations_from_jax_carries_the_reference_parameters():
    import jax
    sigma, pi = ref_perm.make_two_permutations(jax.random.PRNGKey(7), 300)
    ts, tp = convert.permutations_from_jax(np.asarray(sigma), np.asarray(pi),
                                           "cpu")
    assert ts.dtype == tp.dtype == torch.int32
    assert np.array_equal(ts.numpy(), np.asarray(sigma))
    assert np.array_equal(tp.numpy(), np.asarray(pi))
    with pytest.raises(ValueError, match="not a permutation"):
        convert.permutations_from_jax(np.zeros(300, np.int32),
                                      np.asarray(pi), "cpu")
    with pytest.raises(ValueError, match="differ"):
        convert.permutations_from_jax(np.arange(10), np.asarray(pi), "cpu")


@pytest.mark.parametrize("bad", ["value_past_d", "repeat", "short"])
def test_engine_refuses_params_that_are_not_permutations(bad):
    """The signing kernels keep pi as uint16 and assume its values lie in
    [0, D): the engine takes only permutations of [0, D) as params."""
    from repro_torch.core.engine import SketchConfig, SketchEngine
    cfg = SketchConfig(d=64, k=16)
    sigma, pi = t_perm.make_two_permutations(torch.Generator().manual_seed(0),
                                             64, device="cpu")
    SketchEngine(cfg, device="cpu", params=(sigma, pi))
    bad_pi = pi.clone()
    if bad == "value_past_d":
        bad_pi[int(torch.argmax(pi))] = 70_000
    elif bad == "repeat":
        bad_pi[0] = bad_pi[1]
    else:
        bad_pi = bad_pi[:63]
    with pytest.raises(ValueError, match="permutations of"):
        SketchEngine(cfg, device="cpu", params=(sigma, bad_pi))


def test_host_device_views_keep_bits():
    words = np.array([[0, 1, 2**31, 2**32 - 1]], np.uint32)
    t = tdevice.u32_to_device(words, CPU)
    assert t.dtype == torch.int32
    assert np.array_equal(tdevice.u32_to_host(t), words)
    h = torch.tensor([[-1, 0, 2**62]], dtype=torch.int64)
    assert hashes_to_host(h).tolist() == [[2**64 - 1, 0, 2**62]]


# -- the import rule ---------------------------------------------------------

def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.serve.search" in mods
    for m in ("distributed.sharding", "distributed.parallel",
              "distributed.collectives", "launch.mesh", "launch.specs",
              "launch.ranks"):
        assert f"repro_torch.{m}" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro")
                     and sys.modules[m] is not None)
        assert not bad, bad
        print("ok", len({mods!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


EXAMPLES = [ROOT / "examples" / f"{n}_torch.py"
            for n in ("quickstart", "similarity_search", "dedup_pipeline",
                      "hash_features_classifier", "variance_validation",
                      "train_lm")]


def test_no_port_file_names_jax_or_repro_in_an_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
    assert (ROOT / "chip_smoke.py").is_file()
    assert all(p.is_file() for p in EXAMPLES)
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


# -- the device rule ---------------------------------------------------------

def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    from repro_torch.core.engine import SketchConfig, SketchEngine
    from repro_torch.core.minhash import make_k_permutations
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    from repro_torch.store import (BandedLSHTable, ShardedSketchStore,
                                   SketchStore, StoreConfig)
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build, encdec, transformer
    from repro_torch.serve.decode import generate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scfg = StoreConfig(k=64, n_bands=16, rows_per_band=4)
    gen = torch.Generator().manual_seed(0)
    for make in (lambda: SketchEngine(SketchConfig(d=256, k=64)),
                 lambda: SketchStore(scfg),
                 lambda: ShardedSketchStore(scfg),
                 lambda: SimilaritySearchService(SearchConfig()),
                 lambda: BandedLSHTable(4),
                 lambda: t_perm.make_two_permutations(gen, 64),
                 lambda: make_k_permutations(gen, 64, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert SearchConfig().device == "cuda"
    # the CPU runs only when asked for
    SketchEngine(SketchConfig(d=256, k=64), device="cpu")
    SketchStore(scfg, device="cpu")
    SimilaritySearchService(SearchConfig(d=1 << 12, k=64, n_bands=16,
                                         rows_per_band=4, device="cpu"))
    assert BandedLSHTable(4, device="cpu").device == CPU
    assert t_perm.make_two_permutations(gen, 64, device="cpu")[0].device \
        == CPU
    assert make_k_permutations(gen, 64, 8, device="cpu").device == CPU

    # the LM stack: build, init and generate
    cfg = reduced(get_config("llama3_2_1b"), d_model=64)
    ecfg = reduced(get_config("seamless_m4t_medium"), d_model=64)
    cpu = build(cfg, device="cpu")
    params = cpu.init(0)
    batch = {"tokens": np.ones((1, 4), np.int32)}
    for make in (lambda: build(cfg), lambda: build(ecfg),
                 lambda: transformer.init_params(0, cfg),
                 lambda: encdec.init_params(0, ecfg),
                 lambda: transformer.init_cache(cfg, 1, 8),
                 lambda: convert.lm_params_from_jax({}, cfg, "cuda"),
                 lambda: generate(dataclasses.replace(cpu, device="cuda"),
                                  params, batch, max_new_tokens=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # the CPU runs only when asked for
    assert next(params.parameters()).device == CPU
    assert generate(cpu, params, batch, max_new_tokens=2).shape == (1, 2)
    assert encdec.init_params(0, ecfg, "cpu")["embed"].device == CPU


def test_unported_options_raise_and_name_the_roadmap():
    """Options still to port raise and name the roadmap; dense signing,
    which used to, now answers like the reference engine."""
    import jax
    from repro.core.engine import SketchConfig as RefSketchConfig
    from repro.core.engine import SketchEngine as RefSketchEngine
    from repro_torch.core.engine import SketchConfig, SketchEngine
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    ref = RefSketchEngine(RefSketchConfig(d=256, k=64, use_kernel=False))
    eng = SketchEngine(SketchConfig(d=256, k=64), device="cpu",
                       params=convert.permutations_from_jax(
                           np.asarray(ref.sigma), np.asarray(ref.pi), "cpu"))
    v = (np.random.default_rng(0).random((3, 256)) < 0.1).astype(np.int8)
    want = np.asarray(ref.sign(jax.numpy.asarray(v), layout="dense"))
    assert np.array_equal(eng.sign(v, layout="dense").numpy(), want)
    # the tcp transport, which raised here until it was ported, is a
    # transport the service builds; streaming, which raised here until it
    # was ported, streams single rows that answer as query_sparse does
    from repro_torch.serve.search import TRANSPORTS
    assert TRANSPORTS == ("inproc", "tcp")
    small = SimilaritySearchService(SearchConfig(
        d=1 << 12, k=64, n_bands=16, rows_per_band=4, device="cpu"))
    docs = np.sort(np.random.default_rng(2).integers(0, 1 << 12, (24, 30),
                                                     np.int32), axis=1)
    small.add_sparse(docs)
    with small.stream(max_batch=2, max_delay_ms=1.0) as st:
        tickets = [st.submit_sparse(row, top_k=3) for row in docs[:3]]
        streamed = [t.result(timeout=60) for t in tickets]
    want_ids, want_scores = small.query_sparse(docs[:3], top_k=3)
    for i, (ids, scores) in enumerate(streamed):
        assert np.array_equal(ids, want_ids[i])
        assert np.array_equal(scores, want_scores[i])
    with pytest.raises(ValueError, match="transport"):
        SimilaritySearchService(SearchConfig(transport="udp", device="cpu"))
    # bands off word boundaries, which raised until the raw-signature path
    # was ported, now serve like the reference service
    from repro.serve.search import SearchConfig as RefSearchConfig
    from repro.serve.search import SimilaritySearchService as RefService
    common = dict(d=1 << 12, k=60, n_bands=20, rows_per_band=3, b=8)
    ref_svc = RefService(RefSearchConfig(**common))
    svc = SimilaritySearchService(
        SearchConfig(device="cpu", **common),
        params=convert.permutations_from_jax(np.asarray(ref_svc.engine.sigma),
                                             np.asarray(ref_svc.engine.pi),
                                             "cpu"))
    assert not svc.packed_ingest and not ref_svc.packed_ingest
    idx = np.sort(np.random.default_rng(1).integers(0, 1 << 12, (40, 30),
                                                    np.int32), axis=1)
    svc.add_sparse(idx)
    ref_svc.add_sparse(idx)
    for got, want in zip(svc.query_sparse(idx[:8], top_k=3),
                         ref_svc.query_sparse(idx[:8], top_k=3)):
        assert np.array_equal(got, want)


def test_library_path_digests_the_shared_headers(tmp_path, monkeypatch):
    """An edited or added header names a new library, so no stale build
    loads; every source in SOURCES is in the checkout."""
    from repro_torch.kernels import _build
    assert {"cminhash_dense", "cminhash_packed"} <= set(_build.SOURCES)
    assert all((_build.CSRC / f"{n}.cu").is_file() for n in _build.SOURCES)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("#define X 1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    assert first.parent == _build.BUILD
    (tmp_path / "h.cuh").write_text("#define X 2\n")
    edited = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// another header\n")
    added = _build.library_path("k")
    assert len({first, edited, added}) == 3


# -- small leftovers of the ported modules -----------------------------------

def test_classical_parameter_bytes_matches_reference():
    from repro.core.engine import SketchEngine as RefSketchEngine
    from repro_torch.core.engine import SketchEngine
    for d, k in ((4096, 512), (1 << 16, 256), (7, 1)):
        assert SketchEngine.classical_parameter_bytes(d, k) == \
            RefSketchEngine.classical_parameter_bytes(d, k)


def test_random_permutation_draws_what_make_two_permutations_draws():
    """The reference draws from JAX's PRNG, which torch cannot reproduce:
    both give int32 permutations of [0, d), and the port's pair is two
    draws of ``random_permutation`` from one generator."""
    import jax
    ref = np.asarray(ref_perm.random_permutation(jax.random.PRNGKey(3), 300))
    got = t_perm.random_permutation(torch.Generator().manual_seed(3), 300,
                                    device="cpu")
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    assert np.array_equal(np.sort(got.numpy()), np.sort(ref))
    gen = torch.Generator().manual_seed(5)
    first = t_perm.random_permutation(gen, 257, device="cpu")
    second = t_perm.random_permutation(gen, 257, device="cpu")
    sigma, pi = t_perm.make_two_permutations(
        torch.Generator().manual_seed(5), 257, device="cpu")
    assert torch.equal(sigma, first) and torch.equal(pi, second)


def test_densify_matches_reference():
    from repro.data.shingle import densify as ref_densify
    from repro_torch.data.shingle import densify
    idx = np.random.default_rng(2).integers(-1, 300, (9, 40), np.int32)
    idx[3] = -1                                   # an empty row
    got = densify(idx, 300)
    assert got.dtype == np.int8
    assert np.array_equal(got, ref_densify(idx, 300))


@pytest.mark.parametrize("example,args,expect", [
    ("quickstart", [], "classical MinHash would need 8.0 MiB"),
    ("similarity_search", ["--docs", "120", "--queries", "16", "--b", "2"],
     "top-1 self-retrieval: 100%"),
], ids=["quickstart", "similarity_search"])
def test_torch_examples_run_on_the_cpu_without_jax(example, args, expect):
    """The two examples run with jax and repro blocked; the quickstart's
    parameter memory is the reference engine's."""
    from repro.core.engine import SketchConfig as RefSketchConfig
    from repro.core.engine import SketchEngine as RefSketchEngine
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.argv = ["x", "--device", "cpu", *{args!r}]
        runpy.run_path({str(ROOT / "examples" / f"{example}_torch.py")!r},
                       run_name="__main__")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
    if example == "quickstart":
        ref = RefSketchEngine(RefSketchConfig(d=4096, k=512, seed=42))
        assert f"{ref.parameter_bytes / 1024:.0f} KiB" in out.stdout
