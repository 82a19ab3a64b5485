"""A later change adds a configuration, a cell and a per-layer metric as
files alone: the harness finds them by name.  Here they exist only in a
temporary checkout, which holds a copy of the harness beside them."""

import json
import shutil
from pathlib import Path

import torch

from portbench import harness, tiny

BENCH = Path(__file__).resolve().parent
IGNORE = shutil.ignore_patterns("out", "cache", "__pycache__")


def test_a_cell_that_exists_only_as_new_files(tmp_path):
    bench = tmp_path / BENCH.name
    shutil.copytree(BENCH, bench, ignore=IGNORE)
    cfg = json.loads((bench / "configs" / "web_neardup_262k.json")
                     .read_text())
    cfg.update({"index_sets": 384, "ingest_batch": 128,
                "corpus": {**cfg["corpus"], "dup_fraction": 0.5}})
    (bench / "configs" / "web_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "recheck.json").write_text(json.dumps({
        "client": "query_batches", "batch": 40, "top_k": 3,
        "near_copy_share": 1.0, "edit_fraction": 0.02, "pool_batches": 2,
        "check_rows_per_batch": 40, "profile_steps": 2,
        "profile_from": 0.0}))
    (bench / "metrics" / "rows_per_step.py").write_text(
        '"""Query rows a step."""\n\n\ndef read(run):\n'
        '    return run.rows / run.steps if run.steps else None\n')
    e2e = [{"name": n, "unit": u, "better": b, "bound": 0.05,
            "source": "host_clock"}
           for n, u, b in (("queries_per_s", "queries/s", "higher"),
                           ("setup_s", "s", "lower"))]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "command": ["python3", f"{BENCH.name}/run.py"],
        "paths": [BENCH.name], "run_seconds": 10,
        "configs": [{"name": "web_tiny", "source": "test",
                     "file": f"{BENCH.name}/configs/web_tiny.json",
                     "reduced": [], "why": "test"}],
        "workloads": [{"name": "web_tiny.recheck", "config": "web_tiny",
                       "traffic": "recheck", "chips": 1, "why": "test"}],
        "end_to_end": e2e,
        "per_layer": [{"name": "rows_per_step", "unit": "rows",
                       "better": "higher", "source": "program_counter",
                       "layer": "front door", "moves": "queries_per_s"},
                      {"name": "sign_ms", "unit": "ms", "better": "lower",
                       "source": "program_span", "layer": "front door",
                       "moves": "queries_per_s"}]}))

    traced = harness.run(tmp_path, "web_tiny.recheck", 5, 0.3, True,
                         device="cpu")
    assert traced["correct"]
    assert traced["metrics"]["rows_per_step"]["value"] == 40
    assert set(traced["metrics"]) == {"rows_per_step", "sign_ms"}
    plain = harness.run(tmp_path, "web_tiny.recheck", 5, 0.3, False,
                        device="cpu")
    assert plain["correct"]
    assert set(plain["metrics"]) == {"queries_per_s", "setup_s"}


def test_the_same_seed_gives_the_same_inputs():
    def inputs(seed):
        mod = harness.load_module(BENCH, "clients", "query_batches")
        cfg = harness._merge(harness.load_json(BENCH, "configs",
                                               "movielens10m_jaccard"),
                             tiny.TINY["ml10m_knn"]["config"])
        tr = harness._merge(harness.load_json(BENCH, "traffic", "knn_batch"),
                            tiny.TINY["ml10m_knn"]["traffic"])
        d = mod.Client(BENCH, cfg, tr, seed=seed,
                          device=torch.device("cpu"))
        d.setup()
        d.release()
        return d.ingest, d.pool, d.sigma, d.pi
    a, b, c = inputs(2 ** 33 + 1), inputs(2 ** 33 + 1), inputs(2 ** 33 + 2)
    for x, y in zip(a[:2], b[:2]):
        assert all(u.tobytes() == v.tobytes() for u, v in zip(x, y))
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    assert a[1][0].tobytes() != c[1][0].tobytes()
