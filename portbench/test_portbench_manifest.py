"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(m["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in m["command"])
    for w in m["command"]:
        if "/" in w:        # a file of the repo that the command names
            assert any(w.startswith(p + "/") for p in m["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = manifest()["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    entries = manifest()[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    m = manifest()
    used = {w["config"] for w in m["workloads"]}
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    assert 1 <= len(m["configs"]) <= 24
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        with open(ROOT / c["file"]) as f:
            body = json.load(f)
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert key in body and key in body["reduced"]
            assert not key.endswith(("_dim", "_rank"))
        assert set(body["reduced"]) == set(c["reduced"])
        assert (BENCH / "references" / f"{body['reference']}.py").is_file()
        assert (BENCH / "corpora" / f"{body['corpus']['kind']}.py").is_file()


def test_workloads():
    m = manifest()
    configs = {c["name"] for c in m["configs"]}
    assert 1 <= len(m["workloads"]) <= 24
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (BENCH / "clients" / f"{traffic['client']}.py").is_file()
    assert len(pairs) == len(m["workloads"])
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)


def test_end_to_end_metrics():
    m = manifest()
    names = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert (BENCH / "e2e" / f"{e['name']}.py").is_file()


def reported(m: dict, cell: str) -> set:
    return {e["name"] for e in m["end_to_end"]
            if cell in e.get("workloads", [cell])}


def test_per_layer_metrics_move_what_their_cells_report():
    m = manifest()
    cells = {w["name"] for w in m["workloads"]}
    assert 1 <= len(m["per_layer"]) <= 128
    for e in m["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES and line(e["layer"])
        for cell in e.get("workloads", cells):
            assert cell in cells
            assert e["moves"] in reported(m, cell)
        assert (BENCH / "metrics" / f"{e['name']}.py").is_file()
        if "roofline" in e["name"]:
            assert e["name"].endswith("_roofline") and e["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    m = manifest()
    for w in m["workloads"]:
        e2e = reported(m, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in e.get("workloads", [w["name"]])
                   for e in m["per_layer"])
