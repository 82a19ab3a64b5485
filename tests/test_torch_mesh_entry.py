"""Signing, the search service, dedup and ``generate`` over a mesh against
the JAX package's own mesh runs, on the CPU.

The reference runs each entry point with ``mesh=`` on 8 fake host devices
(``repro.launch.mesh.make_host_mesh``, whose axes are Auto), in two
subprocesses started with the module: one signs, the other runs the
service, dedup and ``generate``.  The port's twin is 8 gloo ranks
(``launch.ranks.RankPool(8, device="cpu", threads=1)``), every rank
calling the same entry point with the same host batch, as a mesh call
asks.  The inputs are made from a seed with numpy; pi and sigma are the
reference's (``convert.permutations_from_jax``), the weights too
(``convert.lm_params_from_jax``).  Every comparison is exact: words,
ids, scores, ``keep``/``cluster_of`` and greedy tokens, on every rank,
including qwen3_moe at its capacity factor 1.25, where the reference's
mesh run drops other tokens than one device does.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import RankPool
from repro_torch.models import build

ROOT = Path(__file__).resolve().parent.parent
WORLD = 8
MESHES = [(2, 4), (4, 2), (8, 1)]
K = 100                                  # signing: 25 words at b = 8
SIGN_SEED = 3
SIGN_LAYOUTS = [("sparse", 4096), ("dense", 1024), ("dense", 16384)]
PACKS = [None, 8, 32]
ROWS = [8, 16]
SEARCH = {"d": 4096, "k": 64, "n_bands": 16, "rows_per_band": 4}
N_DOCS, N_QUERY, TOP_K = 256, 16, 5
ARCHS = ["llama3_2_1b", "qwen3_moe_30b_a3b"]
N_NEW = 4

_REF_MESH = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_host_mesh
inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
part = sys.argv[4]
out = {}


def raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


if part == "sign":
    from repro.core.engine import SketchConfig, SketchEngine
    for shape in spec["meshes"]:
        mesh = make_host_mesh(*shape)
        for layout, d in spec["layouts"]:
            eng = SketchEngine(SketchConfig(d=d, k=spec["k"],
                                            seed=spec["seed"]), mesh)
            data = inp[f"{layout}_{d}"]
            tag = f"sign_{shape[0]}x{shape[1]}_{layout}_{d}"
            for pack in spec["packs"]:
                for b in spec["rows"]:
                    out[f"{tag}_{pack}_{b}"] = np.asarray(eng.sign(
                        jnp.asarray(data[:b]), layout=layout, pack_b=pack))
            out[f"{tag}_raises"] = np.asarray(raises(lambda: np.asarray(
                eng.sign(jnp.asarray(data[:5]), layout=layout))))
else:
    from repro.configs import get_config, reduced
    from repro.data.dedup import DedupConfig, dedup_corpus
    from repro.models import build
    from repro.serve.decode import generate
    from repro.serve.search import SearchConfig, SimilaritySearchService
    mesh = make_host_mesh(2, 4)
    svc = SimilaritySearchService(SearchConfig(**spec["search"]), mesh)
    svc.add_sparse(inp["docs_idx"])
    ids, scores = svc.query_sparse(inp["docs_idx"][:spec["n_query"]],
                                   top_k=spec["top_k"])
    out["search_ids"], out["search_scores"] = (np.asarray(ids),
                                               np.asarray(scores))
    out["search_raises"] = np.asarray(raises(
        lambda: svc.add_sparse(inp["docs_idx"][:7])))
    docs = list(inp["docs"])
    res = dedup_corpus(docs, DedupConfig(), mesh)
    for f in ("keep", "cluster_of", "signatures"):
        out[f"dedup_{f}"] = np.asarray(getattr(res, f))
    out["dedup_n"] = np.asarray([res.n_candidates, res.n_verified])
    out["dedup_raises"] = np.asarray(raises(
        lambda: dedup_corpus(docs[:-1], DedupConfig(), mesh)))
    for arch in spec["archs"]:
        cfg = dataclasses.replace(reduced(get_config(arch), d_model=64),
                                  dtype="float32", param_dtype="float32")
        bundle = build(cfg)
        params = bundle.init(jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(inp["prompts"])}
        out[f"gen_{arch}_one"] = generate(bundle, params, batch,
                                          max_new_tokens=spec["n_new"])
        for shape in spec["meshes"]:
            out[f"gen_{arch}_{shape[0]}x{shape[1]}"] = generate(
                bundle, params, batch, max_new_tokens=spec["n_new"],
                mesh=make_host_mesh(*shape))
np.savez(os.path.join(sys.argv[2], f"{part}.npz"), **out)
"""


def _make_inputs() -> dict:
    from repro_torch.data.shingle import batch_shingles
    from repro_torch.data.synthetic import corpus_with_duplicates
    rng = np.random.default_rng(0)
    sparse = rng.integers(0, 4096, (max(ROWS), 48)).astype(np.int32)
    for row, n in enumerate(rng.integers(20, 49, max(ROWS))):
        sparse[row, n:] = -1
    inp = {"sparse_4096": sparse}
    for layout, d in SIGN_LAYOUTS:
        if layout == "dense":
            inp[f"dense_{d}"] = (rng.random((max(ROWS), d)) < 0.05
                                 ).astype(np.int8)
    docs, _ = corpus_with_duplicates(N_DOCS, vocab=2000, doc_len=64,
                                     dup_fraction=0.4, seed=3)
    inp["docs"] = np.stack(docs)
    inp["docs_idx"] = batch_shingles(docs, n=3, d=SEARCH["d"])
    inp["prompts"] = rng.integers(0, 256, (8, 12)).astype(np.int32)
    return inp


class _RefRuns:
    """The reference's subprocesses; ``ref[key]`` waits for the one that
    writes ``key``."""

    def __init__(self, out: Path, procs: dict):
        self.out, self.procs, self.got = out, procs, {}

    def __getitem__(self, key: str) -> np.ndarray:
        part = "sign" if key.startswith("sign_") else "rest"
        if part not in self.got:
            _, err = self.procs[part].communicate(timeout=600)
            assert self.procs[part].returncode == 0, err
            self.got[part] = dict(np.load(self.out / f"{part}.npz"))
        return self.got[part][key]


@pytest.fixture(scope="module")
def inputs() -> dict:
    return _make_inputs()


@pytest.fixture(scope="module")
def ref(inputs, tmp_path_factory):
    """The reference's mesh runs, started at once and read when needed."""
    out = tmp_path_factory.mktemp("mesh_entry")
    np.savez(out / "inputs.npz", **inputs)
    spec = json.dumps({"meshes": [list(s) for s in MESHES],
                       "layouts": SIGN_LAYOUTS, "k": K, "seed": SIGN_SEED,
                       "packs": PACKS, "rows": ROWS, "search": SEARCH,
                       "n_query": N_QUERY, "top_k": TOP_K, "archs": ARCHS,
                       "n_new": N_NEW})
    procs = {part: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF_MESH),
         str(out / "inputs.npz"), str(out), spec, part],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        for part in ("sign", "rest")}
    try:
        yield _RefRuns(out, procs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def pool(ref):
    """Eight gloo ranks on the CPU, one torch thread each (started after the
    reference's subprocesses, which run meanwhile)."""
    p = RankPool(WORLD, device="cpu", threads=1, timeout=60)
    try:
        yield p
    finally:
        p.close()


def _ref_perms(d: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference engine's (sigma, pi) for ``SketchConfig(d, seed=)``."""
    import jax
    from repro.core.permutations import make_two_permutations
    return tuple(np.asarray(p) for p in make_two_permutations(
        jax.random.PRNGKey(seed), d))


def _lm_cfg(arch: str):
    return dataclasses.replace(reduced(get_config(arch), d_model=64),
                               dtype="float32", param_dtype="float32")


def _ref_tree(arch: str) -> dict:
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro.models import build as ref_build
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch), d_model=64),
                               dtype="float32", param_dtype="float32")
    return jax.tree.map(np.asarray, ref_build(rcfg).init(
        jax.random.PRNGKey(0)))


def _delta(before: dict) -> dict:
    """The ``mesh.*`` counters that moved since ``before``."""
    return {k: v - before.get(k, 0) for k, v in col.counters().items()
            if v != before.get(k, 0)}


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


# -- signing -----------------------------------------------------------------

def _r_sign(shape, layout, d, perms, data):
    """Every (pack_b, rows) case of one layout on a rank of ``shape``: the
    words, the collectives and the rows counted a call, and whether 5 rows
    raise."""
    from repro_torch.core.engine import SketchConfig, SketchEngine
    from repro_torch.obs import metrics as obs_metrics
    mesh = make_host_mesh(*shape, device="cpu")
    eng = SketchEngine(SketchConfig(d=d, k=K), mesh, device="cpu",
                       params=convert.permutations_from_jax(*perms, "cpu"))
    rows = obs_metrics.default().counter("engine.sign.rows")
    out = {}
    for pack in PACKS:
        for b in ROWS:
            before, n0 = col.counters(), rows.value
            words = eng.sign(data[:b], layout=layout, pack_b=pack)
            out[pack, b] = (words.numpy().view(np.uint32), _delta(before),
                            rows.value - n0)
    return out, _raises(lambda: eng.sign(data[:5], layout=layout))


@pytest.mark.parametrize("layout,d", SIGN_LAYOUTS)
@pytest.mark.parametrize("shape", MESHES)
def test_signing_matches_the_reference_mesh(pool, ref, inputs, shape,
                                            layout, d):
    """Sparse and dense rows (D on both sides of ``PACKED_MIN_D``), raw and
    packed at b = 8 and 32, 8 and 16 rows: every rank's words equal the
    reference's mesh words bit for bit, one counted all-gather of the
    rank's words over ``data`` a call, the rows the caller asked for
    counted; 5 rows raise ``ValueError`` on both sides."""
    perms = _ref_perms(d, SIGN_SEED)
    res = pool.run(_r_sign, shape, layout, d, perms, inputs[f"{layout}_{d}"])
    tag = f"sign_{shape[0]}x{shape[1]}_{layout}_{d}"
    assert bool(ref[f"{tag}_raises"])
    for cases, raised in res:
        assert raised
        for (pack, b), (words, gathers, rows) in cases.items():
            want = ref[f"{tag}_{pack}_{b}"]
            assert words.shape == want.shape
            assert np.array_equal(words, want.view(np.uint32)), (pack, b)
            assert gathers == {"mesh.all_gather.calls": 1,
                               "mesh.all_gather.bytes":
                               words.nbytes // shape[0]}
            assert rows == b


# -- the service and its stream ----------------------------------------------

def _r_service(shape, perms, docs_idx):
    """Ingest then query on a rank; a stream of the same queries; whether
    an ingest of 7 rows raises."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    mesh = make_host_mesh(*shape, device="cpu")
    svc = SimilaritySearchService(
        SearchConfig(**SEARCH, device="cpu"), mesh,
        params=convert.permutations_from_jax(*perms, "cpu"))
    before = col.counters()
    svc.add_sparse(docs_idx)
    ids, scores = svc.query_sparse(docs_idx[:N_QUERY], top_k=TOP_K)
    gathers = _delta(before)
    before = col.counters()
    with svc.stream(max_batch=4, max_delay_ms=1.0) as st:
        tickets = [st.submit_sparse(row, top_k=TOP_K)
                   for row in docs_idx[:N_QUERY]]
        streamed = [t.result(timeout=30) for t in tickets]
    stream_counts = _delta(before)
    raised = _raises(lambda: svc.add_sparse(docs_idx[:7]))
    return {"ids": ids, "scores": scores, "gathers": gathers,
            "streamed": streamed, "stream_counts": stream_counts,
            "raised": raised, "size": svc.size}


@pytest.fixture(scope="module")
def service_runs(pool, inputs):
    return pool.run(_r_service, (2, 4), _ref_perms(SEARCH["d"], 0),
                    inputs["docs_idx"])


def test_service_matches_the_reference_mesh(service_runs, ref):
    """The in-process service on (2, 4): 256 documents ingested, 16
    queried; every rank's ids and scores equal the reference's, two
    counted all-gathers (the ingest's and the query's signing); an ingest
    of 7 rows raises on both sides and leaves the index as it was."""
    assert bool(ref["search_raises"])
    for r in service_runs:
        assert np.array_equal(r["ids"], ref["search_ids"])
        assert np.array_equal(r["scores"], ref["search_scores"])
        assert r["gathers"]["mesh.all_gather.calls"] == 2
        assert set(r["gathers"]) == {"mesh.all_gather.calls",
                                     "mesh.all_gather.bytes"}
        assert r["raised"] and r["size"] == N_DOCS


def test_stream_over_a_mesh_signs_on_the_rank_alone(service_runs, ref):
    """A stream over the mesh service (batches of up to 4, coalesced by
    each rank's own timing): every ticket equals the reference's answer
    for its row, and no rank issues a collective."""
    for r in service_runs:
        assert r["stream_counts"] == {}
        for i, (ids, scores) in enumerate(r["streamed"]):
            assert np.array_equal(ids, ref["search_ids"][i])
            assert np.array_equal(scores, ref["search_scores"][i])


# -- dedup -------------------------------------------------------------------

def _r_dedup(shape, perms, docs):
    from repro_torch.data.dedup import DedupConfig, dedup_corpus
    mesh = make_host_mesh(*shape, device="cpu")
    params = convert.permutations_from_jax(*perms, "cpu")
    res = dedup_corpus(list(docs), DedupConfig(), mesh, device="cpu",
                       params=params)
    raised = _raises(lambda: dedup_corpus(list(docs[:-1]), DedupConfig(),
                                          mesh, device="cpu", params=params))
    return dataclasses.asdict(res), raised


def test_dedup_matches_the_reference_mesh(pool, ref, inputs):
    """``dedup_corpus`` over (2, 4), 256 documents: ``keep``,
    ``cluster_of``, the signatures and the pair counts equal the
    reference's mesh run on every rank; 255 documents raise on both
    sides."""
    from repro_torch.data.dedup import DedupConfig
    cfg = DedupConfig()
    res = pool.run(_r_dedup, (2, 4), _ref_perms(cfg.d, cfg.seed),
                   inputs["docs"])
    assert bool(ref["dedup_raises"])
    for got, raised in res:
        assert raised
        for f in ("keep", "cluster_of", "signatures"):
            assert np.array_equal(got[f], ref[f"dedup_{f}"]), f
        assert [got["n_candidates"], got["n_verified"]] \
            == ref["dedup_n"].tolist()


# -- generate ----------------------------------------------------------------

def _r_generate(arch, shape, tree, prompts, n_new):
    """Greedy ``generate`` over ``shape`` from the rank's slices of the
    reference's weights, and what each collective it issued carried."""
    from repro_torch.serve.decode import generate
    cfg = _lm_cfg(arch)
    bundle = build(cfg, device="cpu")
    mesh = make_host_mesh(*shape, device="cpu")
    params = convert.lm_params_from_jax(tree, cfg, "cpu")
    local = sh.shard_tree(params, sh.param_shardings(params, mesh))
    seen = []
    with col.watch(lambda kind, t, n: seen.append(
            (kind, str(t.dtype), tuple(t.shape), n))):
        toks = generate(bundle, local, {"tokens": prompts},
                        max_new_tokens=n_new, mesh=mesh)
    return toks, seen


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference_mesh(pool, ref, inputs, arch, shape):
    """Greedy ``generate`` of 8 x 12 prompts, 4 tokens, reduced (d_model
    64, float32, qwen3_moe at its capacity factor 1.25): every rank's
    tokens equal the reference's own mesh run.  The only int32 all-gather
    of the rank's tokens is the last collective, over the 8 rows split on
    ``data``.  On (2, 4) the reference's qwen3_moe tokens differ from its
    one-device tokens: the mesh's token groups drop others."""
    tree = _ref_tree(arch)
    res = pool.run(_r_generate, arch, shape, tree, inputs["prompts"], N_NEW)
    want = ref[f"gen_{arch}_{shape[0]}x{shape[1]}"]
    if arch == "qwen3_moe_30b_a3b" and shape == (2, 4):
        assert not np.array_equal(want, ref[f"gen_{arch}_one"])
    local = (len(want) // shape[0], N_NEW)
    for toks, seen in res:
        assert toks.dtype == np.int32 and np.array_equal(toks, want)
        mine = [s for s in seen if s[1] == "torch.int32" and s[2] == local]
        assert mine == [("all_gather", "torch.int32", local, shape[0])]
        assert seen[-1] == mine[0]


def test_generate_no_tokens_over_a_mesh(pool, inputs):
    """``max_new_tokens=0`` over (2, 4): (B, 0) on every rank and no
    collective."""
    tree = _ref_tree("llama3_2_1b")
    for toks, seen in pool.run(_r_generate, "llama3_2_1b", (2, 4), tree,
                               inputs["prompts"], 0):
        assert toks.shape == (8, 0) and seen == []


def test_generate_keeps_rows_the_batch_axes_do_not_divide(pool, inputs):
    """A batch of 6 rows over (4, 2): the rows stay replicated, as
    ``batch_shardings`` leaves them, no token gather is issued, and every
    rank's tokens equal one device's."""
    from repro_torch.serve.decode import generate
    arch = "llama3_2_1b"
    tree = _ref_tree(arch)
    prompts = inputs["prompts"][:6]
    cfg = _lm_cfg(arch)
    want = generate(build(cfg, device="cpu"),
                    convert.lm_params_from_jax(tree, cfg, "cpu"),
                    {"tokens": prompts}, max_new_tokens=N_NEW)
    for toks, seen in pool.run(_r_generate, arch, (4, 2), tree, prompts,
                               N_NEW):
        assert np.array_equal(toks, want)
        assert not [s for s in seen if s[1] == "torch.int32"
                    and s[2][-1] == N_NEW]


# -- jit_train_step ----------------------------------------------------------

def _r_train(shape, tree, batch):
    """One step through the three-argument ``jit_train_step`` and one
    through the reference's five arguments, each from the same state."""
    from repro_torch.launch import specs
    from repro_torch.train.train_loop import init_train_state, jit_train_step
    cfg = _lm_cfg("llama3_2_1b")
    bundle = build(cfg, device="cpu")
    mesh = make_host_mesh(*shape, device="cpu")
    tc = TrainConfig(warmup_steps=0, learning_rate=1e-3)
    full = convert.lm_params_from_jax(tree, cfg, "cpu")
    shapes = (specs.params_shape(bundle),
              {"tokens": torch.empty(batch["tokens"].shape,
                                     dtype=torch.int32, device="meta")})
    out = []
    for args in ((), shapes):
        params, opt = init_train_state(full, tc, mesh)
        params, opt, m = jit_train_step(bundle, tc, mesh, *args)(
            params, opt, batch)
        out.append(({n: p.detach().clone()
                     for n, p in params.named_parameters()},
                    {k: float(v) for k, v in m.items()}))
    (p3, m3), (p5, m5) = out
    return m3 == m5 and all(torch.equal(p3[n], p5[n]) for n in p3), m3


def test_jit_train_step_takes_the_reference_shape_arguments(pool):
    """``jit_train_step(bundle, tc, mesh, params_shape, batch_shape)``, the
    reference's call, on (2, 4): the same step as the three-argument call,
    parameters and metrics equal, on every rank."""
    tree = _ref_tree("llama3_2_1b")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 256, (8, 16)).astype(np.int32)}
    res = pool.run(_r_train, (2, 4), tree, batch)
    for same, metrics in res:
        assert same and np.isfinite(metrics["loss"])
    assert len({json.dumps(m, sort_keys=True) for _, m in res}) == 1
