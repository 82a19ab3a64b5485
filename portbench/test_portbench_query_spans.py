"""The per-layer metrics that read the spans inside the query legs
(``upload_ms``, ``spill_ms``, ``host_wait_ms``, ``fallback_useful_pct``,
``upload_gbps``, ``spill_hits``), from a tiny traced run of each cell on
the CPU."""

import math
from pathlib import Path

import pytest

from portbench import harness, tiny

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 29
NEW = ("upload_ms", "spill_ms", "host_wait_ms", "fallback_useful_pct",
       "upload_gbps", "spill_hits")


@pytest.mark.parametrize("cell", ["web_crawl_mixed", "ml10m_knn"])
def test_a_traced_run_reports_the_query_legs(cell):
    out = harness.run(ROOT, cell, SEED, 0.3, True, device="cpu",
                      overrides=tiny.overrides(cell))
    assert out["correct"]
    got = {name: out["metrics"][name]["value"] for name in NEW}
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert 0 < got["fallback_useful_pct"] <= 100
