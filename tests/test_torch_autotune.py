"""The port's autotuner on the CPU: the reference's cache contract
(``tests/test_autotune.py``, ``tests/test_query_fused.py``'s
``test_autotune_knows_query_kinds``) over the port's kinds.

``recommend`` never measures and, with no cache, returns the geometry each
kernel had before it took a knob; ``measure`` caches a winner, injects the
default and duels it (the guard), trusts explicit candidates, re-sweeps
only when forced; the JSON file at ``$REPRO_AUTOTUNE_CACHE`` persists and
reloads, and holds the JAX package's entries beside the port's.  A CPU
call resolves no knobs (the plain version has none), and the knobs change
no answer.
"""

import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch.core.engine import SketchConfig, SketchEngine
from repro_torch.kernels import autotune
from repro_torch.kernels import cminhash_kernel as kd
from repro_torch.kernels import cminhash_packed as kpk
from repro_torch.kernels import cminhash_sparse as ks
from repro_torch.kernels import collision_kernel as kc
from repro_torch.kernels import lsh_probe as kp
from repro_torch.kernels import query_fused as kq
from repro_torch.obs import metrics as obs_metrics


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    autotune.clear_cache()
    ref_autotune.clear_cache()
    yield
    autotune.clear_cache()
    ref_autotune.clear_cache()


def _count(name: str) -> int:
    return obs_metrics.default().counter(name).value


# the geometry each kernel launched before the autotuner (csrc/)
TODAY = {"sparse": {"placement": -1}, "dense_rows": {"placement": -1},
         "dense_bits": {"placement": -1}, "fold": {"threads": 256},
         "probe": {"group": 4, "steps": 4}, "collision": {"block_q": 64}}


@pytest.mark.parametrize("kind", autotune.KINDS)
@pytest.mark.parametrize("shape", [(8, 1 << 16, 256), (1, 64, 16),
                                   (4, 262_144, 8)])
def test_recommend_heuristic_on_miss(kind, shape):
    before = _count("autotune.heuristic")
    assert autotune.recommend(kind, *shape, backend="cuda") == TODAY[kind]
    assert _count("autotune.heuristic") == before + 1
    assert autotune.cached(kind, *shape, backend="cuda") is None


def test_recommend_refuses_unknown_kinds_and_clamps():
    with pytest.raises(ValueError):
        autotune.recommend("nope", 1, 1, 1, backend="cpu")
    with pytest.raises(ValueError):      # the reference's kinds are not ours
        autotune.recommend("sparse_windows", 1, 1, 1, backend="cpu")
    autotune.measure("probe", 256, 64, 8, backend="cpu",
                     candidates=({"group": 2, "steps": 2},), warmup=0,
                     iters=1)
    # a cached winner of the shape class reaches recommend, clamped
    autotune._cache[autotune.cache_key("probe", 256, 64, 8, "cpu")] = {
        "group": 2, "steps": 8}
    assert autotune.recommend("probe", 256, 64, 8, backend="cpu") == {
        "group": 2, "steps": 2}
    # a placement that fits one D of the bucket and not another: the pair
    # table at D = 40,000 but not at 60,000 (both bucket to 65,536)
    pairs = autotune.PLACEMENTS["pairs"]
    assert autotune.placement_fits(pairs, 40_000, 256)
    assert not autotune.placement_fits(pairs, 60_000, 256)
    assert not autotune.placement_fits(pairs, 2048, 64)
    assert not autotune.placement_fits(autotune.PLACEMENTS["shared16"],
                                       (1 << 16) + 1, 256)
    autotune._cache[autotune.cache_key("dense_rows", 8, 40_000, 256,
                                       "cpu")] = {"placement": pairs}
    assert autotune.recommend("dense_rows", 8, 40_000, 256,
                              backend="cpu") == {"placement": pairs}
    assert autotune.recommend("dense_rows", 8, 60_000, 256,
                              backend="cpu") == {"placement": -1}


def test_measure_caches_winner():
    cands = ({"placement": 1}, {"placement": 0})
    best = autotune.measure("sparse", 2, 256, 32, nnz=16, candidates=cands,
                            warmup=1, iters=1)
    assert best in [dict(c) for c in cands]
    assert autotune.cached("sparse", 2, 256, 32, nnz=16) == best
    # recommend now returns the measured winner, not the default
    before = _count("autotune.hit")
    assert autotune.recommend("sparse", 2, 256, 32, nnz=16) == best
    assert _count("autotune.hit") == before + 1
    # bucketing: a same-pow2-class shape hits the same entry
    assert autotune.cached("sparse", 2, 200, 30, nnz=9) == best
    assert autotune.cached("sparse", 2, 1024, 32, nnz=16) is None
    # nnz is part of the sparse key: a different density re-tunes
    assert autotune.cached("sparse", 2, 256, 32, nnz=512) is None
    # the backend is part of the key
    assert autotune.cached("sparse", 2, 256, 32, backend="cuda",
                           nnz=16) is None
    # measure() is sweep-on-MISS: a cached shape class returns at once
    other = {"placement": 1 - best["placement"]}
    again = autotune.measure("sparse", 2, 256, 32, nnz=16,
                             candidates=(other,), warmup=0, iters=1)
    assert again == best
    forced = autotune.measure("sparse", 2, 256, 32, nnz=16, force=True,
                              candidates=(other,), warmup=0, iters=1)
    assert forced == other
    # a candidate that is not offered at the shape (the pair table at
    # K <= 64) never enters the field: nothing ran, nothing is cached
    assert autotune.measure("sparse", 2, 512, 32, nnz=16,
                            candidates=({"placement": 2},), warmup=0,
                            iters=1) == {"placement": -1}
    assert autotune.cached("sparse", 2, 512, 32, nnz=16) is None


def test_measure_guard_rejects_slow_winner(monkeypatch):
    """A default-sweep winner that cannot beat the default in the
    confirmation duel is not cached; the default is, and the rejection is
    counted."""
    default = {"group": 4, "steps": 4}
    sweeps = []

    def fake_sweep(runner, cands, warmup, iters):
        sweeps.append([dict(c) for c in cands])
        if len(sweeps) == 1:       # full sweep: a non-default "winner"
            return (1e-9, next(c for c in cands if c != default))
        return (1e-9, default)     # duel: the default is faster

    monkeypatch.setattr(autotune, "_sweep", fake_sweep)
    before = _count("autotune.guard_rejects")
    best = autotune.measure("probe", 64, 256, 8, backend="cpu", warmup=0,
                            iters=1)
    assert best == default
    assert autotune.cached("probe", 64, 256, 8, backend="cpu") == default
    assert _count("autotune.guard_rejects") == before + 1
    assert len(sweeps) == 2 and sorted(
        map(str, sweeps[1])) == sorted(map(str, [sweeps[0][0], default]))
    # the field is every candidate, the default among them, each once
    assert default in sweeps[0]
    assert len(sweeps[0]) == len(autotune._CANDIDATES["probe"])


def test_measure_guard_injects_a_default_the_candidates_lack(monkeypatch):
    """The signing kinds' default, the launch's own pick (-1), is no
    candidate and runs the kernel of one: the guard keeps it out of the
    field and puts it in the duel, which the winner must take by more
    than the duel's own spread."""
    sweeps, duels = [], []
    duel_times = {}

    def fake_sweep(runner, cands, warmup, iters):
        sweeps.append([dict(c) for c in cands])
        return (1e-9, {"placement": 2})

    def fake_times(runner, cands, warmup, iters):
        duels.append([dict(c) for c in cands])
        return [(c, duel_times[c["placement"]]) for c in cands]

    monkeypatch.setattr(autotune, "_sweep", fake_sweep)
    monkeypatch.setattr(autotune, "_times", fake_times)
    # pairs is faster by less than the spread: the default is cached
    duel_times.update({2: [1.0, 1.3, 1.1], -1: [1.2, 1.25, 1.21]})
    before = _count("autotune.guard_rejects")
    assert autotune.measure("dense_rows", 8, 2048, 512, backend="cpu",
                            warmup=0, iters=1) == {"placement": -1}
    assert _count("autotune.guard_rejects") == before + 1
    # pairs, shared16, global32 all fit at (2048, 512); the default only
    # in the duel
    assert sweeps == [[{"placement": 2}, {"placement": 0},
                       {"placement": 1}]]
    assert duels == [[{"placement": 2}, {"placement": -1}]]
    # faster by more than the spread: the placement is cached
    duel_times.update({2: [1.0, 1.05, 1.02], -1: [1.2, 1.22, 1.21]})
    assert autotune.measure("dense_rows", 8, 2048, 512, backend="cpu",
                            warmup=0, iters=1, force=True) == {
        "placement": 2}
    assert autotune.cached("dense_rows", 8, 2048, 512,
                           backend="cpu") == {"placement": 2}
    sweeps.clear()
    autotune.measure("dense_rows", 8, (1 << 16) + 1, 64, backend="cpu",
                     warmup=0, iters=1)
    # neither shared table is offered there
    assert sweeps == [[{"placement": 1}]]


def test_measure_clamps_a_cached_winner_to_the_shape(monkeypatch):
    """A winner cached at one shape of a class comes back from ``measure``
    clamped to another shape of the class: the pair table fits D = 40,000
    at K = 256 but not D = 60,000, and both bucket to D65536.  The
    engine's signing then passes the launch a placement that fits."""
    from repro_torch.kernels import dispatch
    pairs = {"placement": autotune.PLACEMENTS["pairs"]}
    for kind in autotune.SIGNING:
        autotune._cache[autotune.cache_key(kind, 8, 40_000, 256, "cpu",
                                           nnz=64)] = dict(pairs)
        before = _count("autotune.hit")
        assert autotune.measure(kind, 8, 40_000, 256, backend="cpu",
                                nnz=64) == pairs
        assert autotune.measure(kind, 8, 60_000, 256, backend="cpu",
                                nnz=64) == {"placement": -1}
        assert _count("autotune.hit") == before + 2
    seen = []

    def spy(*a, placement=None, **kw):
        seen.append(placement)
        return torch.zeros((a[0].shape[0], a[2]), dtype=torch.int32)

    monkeypatch.setattr(dispatch, "cminhash_sparse_kernel", spy)
    monkeypatch.setattr(dispatch, "cminhash_dense_kernel", spy)
    monkeypatch.setattr(dispatch, "cminhash_packed", spy)
    for d in (40_000, 60_000):
        pi = torch.randperm(d, generator=torch.Generator().manual_seed(0)
                            ).to(torch.int32)
        dispatch.signatures_sparse(torch.zeros((8, 64), dtype=torch.int32),
                                   pi, 256, autotune_measure=True)
        for impl in ("int8", "packed"):
            dispatch.signatures_dense(torch.zeros((8, d), dtype=torch.int8),
                                      pi, 256, impl=impl,
                                      autotune_measure=True)
    assert seen == [2, 2, 2, -1, -1, -1]


def test_measure_guard_confirms_fast_winner(monkeypatch):
    """A winner that survives the duel is cached as it is, no rejection."""
    winner = {"block_q": 16}

    def fake_sweep(runner, cands, warmup, iters):
        return (1e-9, winner)

    monkeypatch.setattr(autotune, "_sweep", fake_sweep)
    before = _count("autotune.guard_rejects")
    assert autotune.measure("collision", 4, 512, 8, backend="cpu",
                            warmup=0, iters=1) == winner
    assert autotune.cached("collision", 4, 512, 8, backend="cpu") == winner
    assert _count("autotune.guard_rejects") == before


def test_measure_explicit_candidates_bypass_guard(monkeypatch):
    """Explicit candidates= pin the field: no default injection, no duel;
    the caller's winner is trusted as it is."""
    def boom(*a, **k):
        raise AssertionError("guard duel must not run for explicit sweeps")

    monkeypatch.setattr(autotune, "_duel", boom)
    best = autotune.measure("fold", 64, 32, 8, backend="cpu",
                            candidates=({"threads": 128},), warmup=0,
                            iters=1)
    assert best == {"threads": 128}
    assert autotune.cached("fold", 64, 32, 8, backend="cpu") == best


def test_cache_persists_to_json(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    best = autotune.measure("collision", 2, 128, 16, backend="cpu",
                            candidates=({"block_q": 32},), warmup=0, iters=1)
    assert best == {"block_q": 32}
    data = json.loads(path.read_text())
    assert data == {"collision:cpu:B2:D128:K16": {"block_q": 32}}
    # a fresh process (cleared in-process cache) reloads the file
    autotune.clear_cache()
    assert autotune.cached("collision", 2, 128, 16, backend="cpu") == best
    assert autotune.recommend("collision", 2, 100, 9,
                              backend="cpu") == best


def test_one_cache_file_holds_both_packages(tmp_path, monkeypatch):
    """The JAX package and the port write one file; each reads its own
    entries back, and neither's kinds reach the other."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    assert autotune.CACHE_ENV == ref_autotune.CACHE_ENV
    ref_best = ref_autotune.measure(
        "sparse_windows", 2, 128, 16, candidates=({"block_j": 4},),
        warmup=0, iters=1)
    best = autotune.measure("sparse", 2, 128, 16, backend="cpu",
                            candidates=({"placement": 1},), warmup=0,
                            iters=1)
    ref_autotune.measure("dense_int8", 2, 64, 16,
                         candidates=({"block_b": 2, "block_d": 32},),
                         warmup=0, iters=1)
    data = json.loads(path.read_text())
    assert {k.split(":")[0] for k in data} == {"sparse_windows", "sparse",
                                               "dense_int8"}
    autotune.clear_cache()
    ref_autotune.clear_cache()
    assert ref_autotune.cached("sparse_windows", 2, 128, 16) == ref_best
    assert autotune.cached("sparse", 2, 128, 16, backend="cpu") == best
    assert autotune.recommend("dense_rows", 2, 64, 16,
                              backend="cpu") == TODAY["dense_rows"]


def test_measure_dense_kinds_tiny():
    cands = ({"placement": 1},)
    for kind in ("dense_rows", "dense_bits"):
        best = autotune.measure(kind, 2, 64, 16, backend="cpu",
                                candidates=cands, warmup=0, iters=1)
        assert best == {"placement": 1}, kind


@pytest.mark.parametrize("kind,b,d,k,nnz", [
    ("sparse", 4, 256, 32, 12), ("dense_rows", 4, 256, 96, 0),
    ("dense_bits", 4, 256, 96, 0), ("fold", 8, 4, 3, 0),
    ("probe", 64, 32, 3, 0), ("collision", 3, 40, 5, 0)])
def test_default_sweep_of_each_kind_on_the_cpu(kind, b, d, k, nnz):
    """A whole default sweep (synthetic inputs, interleaved rounds, the
    duel) runs each kind's plain version and caches one of its knobs; the
    knobs change no answer."""
    sweeps = _count("autotune.sweeps")
    best = autotune.measure(kind, b, d, k, backend="cpu", nnz=nnz,
                            warmup=1, iters=2)
    assert _count("autotune.sweeps") == sweeps + 1
    assert best in list(autotune._CANDIDATES[kind]) + [TODAY[kind]]
    runner = autotune._make_runner(kind, b, d, k, nnz, 0, "cpu")
    want = runner.plain()
    for knobs in autotune._CANDIDATES[kind]:
        assert torch.equal(runner(knobs)(), want)


def test_probe_sweep_table_ends_walks_as_serving_does():
    """The probe's synthetic table: half the hashes stored (a hit at step
    0), half absent; 32 bands where the entries divide."""
    runner = autotune._make_runner("probe", 64, 256, 4, 0, 0, "cpu")
    got = runner.plain()
    assert got.shape == (64, 4)
    hits = (got >= 0).all(dim=1)
    assert 0.2 < float(hits.float().mean()) < 0.8
    assert not ((got >= 0).any(dim=1) & ~hits).any()


def _calls(dev: str = "cpu"):
    """One call of each wrapper on small tensors on ``dev``, by the
    (kind, B, D, K) it resolves on the card."""
    gen = torch.Generator().manual_seed(0)
    pi = torch.randperm(256, generator=gen).to(torch.int32).to(dev)
    idx = torch.randint(-1, 256, (3, 9), generator=gen,
                        dtype=torch.int32).to(dev)
    v = (torch.rand((3, 256), generator=gen) < 0.1).to(torch.int8).to(dev)
    rows = torch.randint(0, 2 ** 31 - 1, (3, 4, 2), generator=gen,
                         dtype=torch.int32).to(dev)
    rec = torch.full((4 * 64, 5), -1, dtype=torch.int32, device=dev)
    h = torch.randint(0, 2 ** 62, (3, 4), generator=gen).to(dev)
    return {
        ("sparse", 3, 256, 32): lambda: ks.cminhash_sparse_kernel(idx, pi, 32),
        ("dense_rows", 3, 256, 32): lambda: kd.cminhash_dense_kernel(v, pi,
                                                                     32),
        ("dense_bits", 3, 256, 32): lambda: kpk.cminhash_packed_kernel(
            kpk.pack_bits(v), pi, 32),
        ("fold", 3, 4, 2): lambda: kq.fold_rows_kernel(rows),
        ("probe", 12, 64, 3): lambda: kp.lsh_probe_hashes_kernel(
            rec, h, n_slots=64, max_probes=4),
        ("collision", 3, 3, 2): lambda: kc.collision_counts_kernel(
            rows[:, 0].contiguous(), rows[:, 1].contiguous()),
    }


def spy_recommend(monkeypatch) -> list:
    """Record every ``autotune.recommend`` call as (kind, B, D, K,
    backend)."""
    seen = []
    real = autotune.recommend

    def spy(kind, b, d, k, backend=None, nnz=0):
        seen.append((kind, b, d, k, backend))
        return real(kind, b, d, k, backend, nnz)

    monkeypatch.setattr(autotune, "recommend", spy)
    return seen


def test_every_wrapper_resolves_its_knobs_once_a_call(monkeypatch):
    """A wrapper resolves its knobs once a launch, on the card
    (``tests/test_torch_cuda.py``); a CPU tensor's plain version has no
    knobs, so a CPU call resolves nothing and counts no
    ``autotune.heuristic``."""
    seen = spy_recommend(monkeypatch)
    heuristic = _count("autotune.heuristic")
    for key, call in _calls().items():
        call()
        assert seen == [], key
    assert _count("autotune.heuristic") == heuristic
    # nor does a call whose knobs are given
    kc.collision_counts_kernel(torch.zeros((2, 3), dtype=torch.int32),
                               torch.zeros((4, 3), dtype=torch.int32),
                               block_q=16)
    kp.lsh_probe_hashes_kernel(torch.full((64, 5), -1, dtype=torch.int32),
                               torch.zeros((2, 1), dtype=torch.int64),
                               n_slots=64, max_probes=2, group=8, steps=4)
    assert seen == []


def test_engine_autotune_measure_populates_cache():
    cfg = SketchConfig(d=256, k=32, autotune_measure=True, seed=0)
    eng = SketchEngine(cfg, device="cpu")
    idx = np.array([[3, 17, 200, -1]], np.int32)
    sig = eng.signatures_sparse(idx)
    assert autotune.cached("sparse", 1, 256, 32, backend="cpu",
                           nnz=idx.shape[1]) is not None
    v = np.zeros((2, 256), np.int8)
    v[:, ::7] = 1
    dense = eng.signatures_dense(v)
    assert autotune.cached("dense_rows", 2, 256, 32,
                           backend="cpu") is not None
    # values unchanged against the untuned engine
    eng2 = SketchEngine(SketchConfig(d=256, k=32, seed=0), device="cpu")
    assert torch.equal(sig, eng2.signatures_sparse(idx))
    assert torch.equal(dense, eng2.signatures_dense(v))
    assert torch.equal(eng.sign_packed(idx, 4), eng2.sign_packed(idx, 4))


def test_device_words_cache_tracks_mutations():
    from repro_torch.store.packed import PackedConfig, PackedSignatureBuffer
    buf = PackedSignatureBuffer(PackedConfig(k=8, b=32), torch.device("cpu"))
    buf.append(np.arange(16, dtype=np.int32).reshape(2, 8))
    d1 = buf.device_words()
    assert buf.device_words() is d1              # no re-upload, no mutation
    buf.append(np.arange(8, dtype=np.int32).reshape(1, 8))
    d2 = buf.device_words()
    assert d2 is not d1 and d2.shape[0] == 3
    assert (d2.numpy().view(np.uint32) == buf.all_packed()).all()


def test_autotune_knows_query_kinds():
    r = autotune.recommend("fold", 8, 16, 2, backend="cpu")
    assert r == {"threads": 256}
    r = autotune.recommend("probe", 256, 64, 8, backend="cpu")
    assert set(r) == {"group", "steps"} and r["steps"] <= r["group"]
    r = autotune.recommend("collision", 4, 262_144, 256, backend="cpu")
    assert r == {"block_q": 64}
