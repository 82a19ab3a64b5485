"""The check that decides ``correct``, driven end to end on the CPU at a
tiny size (the port's plain versions stand in for the kernels; the
harness's look for a card is the CLI's, and is skipped here).

A sound run is correct; the reference agrees with the port's CPU path on
a slice of each configuration.  The control (the program's own b = 8
path, the nearest lower precision that changes a code at D = 2^16) and
faults planted where an answer or a code is produced must come out not
correct."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, tiny
from portbench.references import cminhash_search as ref

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 11


def run(cell, monkeypatch=None, seconds=0.3, **program):
    out = harness.run(ROOT, cell, SEED, seconds, False, device="cpu",
                      overrides=tiny.overrides(cell, **program))
    return out, {k: c["value"] for k, c in out["checks"].items()}


@pytest.mark.parametrize("cell", ["web_crawl_mixed", "ml10m_knn"])
def test_a_sound_run_is_correct(cell):
    out, checks = run(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert checks == {"index_rows_wrong": 0, "answer_rows_wrong": 0,
                      "fallback_rows_off": 0}
    assert list(out)[-2:] == ["checks", "_notes"]
    assert out["_notes"]["checked"]["rows_compared"] > 0


@pytest.mark.parametrize("cell", ["web_crawl_mixed", "ml10m_knn"])
def test_the_control_is_not_correct(cell):
    out, checks = run(cell, b=8)
    assert not out["correct"]
    assert checks["answer_rows_wrong"] > 0


def test_an_altered_answer_is_not_correct(monkeypatch):
    """A score altered where the brute-force leg produces it."""
    from repro_torch.store import planner
    rank = planner.QueryPlanner._rank

    def altered(self, *a, **kw):
        ids, scores = rank(self, *a, **kw)
        scores[0, 0] += np.float32(1 / 256)
        return ids, scores
    monkeypatch.setattr(planner.QueryPlanner, "_rank", altered)
    out, checks = run("ml10m_knn")
    assert not out["correct"] and checks["answer_rows_wrong"] > 0


def test_an_altered_candidate_answer_is_not_correct(monkeypatch):
    """Two ids swapped where the candidate leg ranks them."""
    from repro_torch.kernels import query_fused
    score = query_fused.score_topk

    def altered(*a, **kw):
        ids, scores, has = score(*a, **kw)
        hit = torch.nonzero(has).flatten()
        if hit.numel():
            ids[hit[0], 0] = ids[hit[0], 0] + 1
        return ids, scores, has
    monkeypatch.setattr(query_fused, "score_topk", altered)
    out, checks = run("web_crawl_mixed")
    assert not out["correct"] and checks["answer_rows_wrong"] > 0


def test_an_altered_code_is_not_correct(monkeypatch):
    """One code of one row altered where the signing kernel produces it."""
    from repro_torch.kernels import dispatch
    sign = dispatch.cminhash_sparse_kernel

    def altered(*a, **kw):
        out = sign(*a, **kw)
        out[0, 0] ^= 1
        return out
    monkeypatch.setattr(dispatch, "cminhash_sparse_kernel", altered)
    out, checks = run("web_crawl_mixed")
    assert not out["correct"] and checks["index_rows_wrong"] > 0


def test_reference_codes_equal_the_ports_signing():
    from repro_torch.core.engine import SketchConfig, SketchEngine
    g = torch.Generator().manual_seed(7)
    d, k = 1 << 12, 64
    sigma = torch.randperm(d, generator=g).to(torch.int32)
    pi = torch.randperm(d, generator=g).to(torch.int32)
    sets = torch.randint(0, d, (40, 30), generator=g).to(torch.int32)
    sets[torch.rand((40, 30), generator=g) < 0.3] = -1
    sets[3] = -1                          # an empty set
    eng = SketchEngine(SketchConfig(d=d, k=k), device="cpu",
                       params=(sigma, pi))
    want = eng.sign(sets.numpy(), layout="sparse")
    assert torch.equal(ref.signatures(sets, sigma, pi, k), want)
    for b in (32, 8, 2):
        words = eng.sign(sets.numpy(), layout="sparse", pack_b=b)
        assert np.array_equal(ref.packed_words(want, b),
                              words.numpy().view(np.uint32))


def test_reference_answers_by_plain_loops():
    g = torch.Generator().manual_seed(3)
    codes = torch.randint(0, 3, (60, 8), generator=g).to(torch.int32)
    idx = ref.Index(codes, n_bands=4, rows_per_band=2, b=32)
    q = torch.randint(0, 3, (9, 8), generator=g).to(torch.int32)
    ids, scores, has, _ = idx.answers(q, 5)
    for r in range(len(q)):
        cand = [i for i in range(60) if any(
            torch.equal(q[r, 2 * j: 2 * j + 2], codes[i, 2 * j: 2 * j + 2])
            for j in range(4))]
        assert has[r] == bool(cand)
        pool = cand or list(range(60))
        order = sorted(pool, key=lambda i: (-int((q[r] == codes[i]).sum()),
                                            i))[:5]
        want = order + [-1] * (5 - len(order))
        assert ids[r].tolist() == want
        assert scores[r].tolist() == [
            int((q[r] == codes[i]).sum()) / 8 if i >= 0 else 0.0
            for i in want]
