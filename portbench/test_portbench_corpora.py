"""The data generators: the shapes, laws and edits their files state."""

import numpy as np
import pytest
import torch

from portbench import harness, rows

CPU = torch.device("cpu")


def corpus(kind, config, seed=1):
    params = harness.load_json(harness.BENCH, "configs", config)["corpus"]
    gen = torch.Generator().manual_seed(seed)
    mod = harness.load_module(harness.BENCH, "corpora", kind)
    return mod, mod.Corpus(params, 1 << 16, gen, CPU), params


def test_folded_zipf_pmf_is_a_law():
    mod, _, _ = corpus("shingled_docs", "web_neardup_262k")
    pmf = mod.folded_zipf_pmf(30000, 1.2)
    assert pmf.shape == (29998,) and np.all(pmf > 0)
    assert pmf.sum() == pytest.approx(1.0)
    assert pmf[0] > pmf[1] > pmf[100]


def test_pages_edits_and_shingles():
    _, c, p = corpus("shingled_docs", "web_neardup_262k")
    src = c.draw(64)
    assert src.shape == (64, p["doc_len"]) and src.dtype == torch.int32
    assert int(src.min()) >= 2 and int(src.max()) < p["vocab"]
    near = c.edit(src, p["edit_fraction"])
    assert int((near != src).sum(dim=1).max()) <= int(256 * 0.05)
    sets = c.sets(src)
    n = rows.lengths(sets)
    for r in range(4):
        row = sets[r, : int(n[r])]
        assert torch.all(row[1:] > row[:-1]) and torch.all(sets[r, n[r]:] < 0)
        assert int(row.max()) < 1 << 16


def test_user_sizes_are_the_same_quantiles_for_every_seed():
    _, a, p = corpus("item_sets", "movielens10m_jaccard", seed=1)
    _, b, _ = corpus("item_sets", "movielens10m_jaccard", seed=2)
    sa, sb = a.sizes(2000), b.sizes(2000)
    assert not torch.equal(sa, sb)
    assert torch.equal(sa.sort().values, sb.sort().values)
    assert int(sa.min()) >= p["size_min"] and int(sa.max()) <= p["size_max"]
    assert float(sa.double().median()) == pytest.approx(p["size_median"],
                                                        abs=2)


def test_users_draw_distinct_active_items_and_edits_redraw_a_share():
    _, c, p = corpus("item_sets", "movielens10m_jaccard")
    src = c.draw(50)
    size = rows.lengths(src)
    sets = c.sets(src)
    assert torch.equal(rows.lengths(sets), size)       # no repeated item
    active = set(c.items.tolist())
    assert set(sets[sets >= 0].tolist()) <= active
    near = c.edit(src, 0.1)
    changed = (near != src).sum(dim=1)
    assert torch.all(changed <= (size.double() * 0.1).floor())
    assert torch.all((near >= 0).sum(dim=1) == size)
