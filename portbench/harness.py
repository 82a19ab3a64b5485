"""Runs one cell of the benchmark once and builds its result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name under this folder: ``configs/<config>.json``,
``traffic/<traffic>.json`` (which names its ``clients/<client>.py``),
``corpora/<kind>.py`` and ``references/<reference>.py`` (named by the
configuration), ``e2e/<metric>.py`` and ``metrics/<metric>.py`` (each a
``read(run)`` that returns the number or None).

A run: the client's set-up (counted in ``setup_s`` from the process's
start), then ``seconds`` of closed-loop steps.  A traced run (``trace``)
samples every span of the program's tracer through the window and
profiles ``profile_steps`` steps from ``profile_from`` of the way in with
``torch.profiler``; it reports the per-layer metrics, an untraced run the
end-to-end ones.  After the window the program's state is read and freed,
and the client's check holds the answers to the plain reference.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from portbench import devtrace, roofline

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
MARKER = "portbench.step"
OUT = "out"                   # traces, inside this folder (gitignored)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    config: dict
    setup_s: float
    window_s: float
    latencies_s: list
    rows: int
    steps: int
    failed: int
    spans: list = dataclasses.field(default_factory=list)
    ops: list = dataclasses.field(default_factory=list)
    profiled: tuple | None = None       # (start_us, end_us) on the trace
    work: list = dataclasses.field(default_factory=list)
    peak: dict | None = None


def load_manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(bench: Path, folder: str, name: str) -> dict:
    with open(bench / folder / f"{name}.json") as f:
        return json.load(f)


def load_module(bench: Path, folder: str, name: str):
    path = bench / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list it, or list no cells and move a metric it
    reports."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def _merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys, one level of nested dicts merged."""
    out = dict(base)
    for key, val in over.items():
        out[key] = {**out[key], **val} if isinstance(val, dict) \
            and isinstance(out.get(key), dict) else val
    return out


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        *, device: str = "cuda", t0: float | None = None,
        overrides: dict | None = None) -> dict:
    """One run of ``workload``; returns its result line's fields.
    ``overrides``: ``config`` and ``traffic`` keys replaced (smaller
    shapes for the CPU tests), ``program`` SearchConfig fields the service
    runs with (the control)."""
    from repro_torch.obs import trace as obs_trace
    t0 = time.perf_counter() if t0 is None else t0
    overrides = overrides or {}
    bench = root / BENCH.name
    manifest = load_manifest(root)
    cell = find_cell(manifest, workload)
    config = _merge(load_json(bench, "configs", cell["config"]),
                    overrides.get("config", {}))
    traffic = _merge(load_json(bench, "traffic", cell["traffic"]),
                     overrides.get("traffic", {}))
    dev = torch.device(device)
    tracer = obs_trace.Tracer(sample_rate=0.0, max_finished=1 << 20)
    before = obs_trace.set_default(tracer)   # before the service is built
    try:
        client = load_module(bench, "clients", traffic["client"]).Client(
            bench, config, traffic, seed=seed % (1 << 63), device=dev,
            program=overrides.get("program"))
        client.setup()
        _sync(dev)
        setup_s = time.perf_counter() - t0
        tracer.sample_rate = 1.0 if trace else 0.0
        window = _window(client, seconds, traffic, trace, dev, bench,
                         workload)
        _sync(dev)
        tracer.sample_rate = 0.0
    finally:
        obs_trace.set_default(before)
    peak_bytes = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    rec = Run(config=config, setup_s=setup_s,
              window_s=window["window_s"], latencies_s=window["lat"],
              rows=window["rows"], steps=window["steps"],
              failed=window["failed"], spans=tracer.drain() if trace else [],
              work=window["work"], peak=roofline.peaks(kind))
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": kind, "count": cell["chips"],
                "memory_peak_bytes": int(peak_bytes)}
    breakdown = None
    if trace and window["trace_path"]:
        breakdown = _read_trace(rec, window, dev_info)

    t_check = time.perf_counter()
    client.release()
    checks = client.check()
    check_s = time.perf_counter() - t_check
    metrics = {}
    for m in metrics_of(manifest, workload, trace):
        folder = "metrics" if trace else "e2e"
        value = load_module(bench, folder, m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": rec.failed == 0 and all(v <= lim
                                              for _, v, lim in checks),
           "attempted": rec.steps, "failed": rec.failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    out["_notes"] = {"checked": getattr(client, "checked", {}),
                     "setup": getattr(client, "setup_phases", {}),
                     "check_s": check_s,
                     "program": getattr(client, "program_state", {}),
                     "latency_ms": _spread_ms(rec.latencies_s),
                     "seed": seed, "seconds": seconds}
    return out


def _spread_ms(lat: list) -> dict:
    """The window's batch latencies in ms: least, quartiles, most, and the
    means of its halves (a drift over the window shows there)."""
    ms = sorted(x * 1e3 for x in lat)
    half = len(lat) // 2
    q = statistics.quantiles(ms, n=4) if len(ms) > 1 else ms * 3
    return {"min": ms[0], "q1": q[0], "median": q[1], "q3": q[2],
            "max": ms[-1],
            "first_half_mean": 1e3 * statistics.fmean(lat[:half] or lat),
            "second_half_mean": 1e3 * statistics.fmean(lat[half:])}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(client, seconds: float, traffic: dict, trace: bool,
            dev: torch.device, bench: Path, workload: str) -> dict:
    """The measured window: closed-loop steps until ``seconds`` have
    passed.  Every step counts, the last one whole."""
    from torch.profiler import ProfilerActivity, profile, record_function
    lat, work, walls = [], [], []
    rows = failed = steps = 0
    n_prof = traffic.get("profile_steps", 20) if trace else 0
    prof_from = seconds * traffic.get("profile_from", 0.4)
    prof = None

    def one_step(profiled: bool) -> float:
        nonlocal rows, failed, steps
        t = time.perf_counter()
        try:
            if profiled:
                walls.append(time.time())
                with record_function(MARKER):
                    rows += client.step()
                    _sync(dev)
                work.append(client.step_work())
            else:
                rows += client.step()
        except Exception:              # a failed request counts as failed
            failed += 1
            if failed == 1:
                traceback.print_exc()
        end = time.perf_counter()
        lat.append(end - t)
        steps += 1
        return end

    start = time.perf_counter()
    while True:
        if n_prof and prof is None \
                and time.perf_counter() - start >= prof_from:
            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts, acc_events=True) as prof:
                for _ in range(n_prof):
                    end = one_step(True)
                    if end - start >= seconds:
                        break
        else:
            end = one_step(False)
        if end - start >= seconds:
            break
    trace_path = None
    if prof is not None:
        out_dir = bench / OUT
        out_dir.mkdir(exist_ok=True)
        trace_path = out_dir / f"trace_{workload}.json"
        prof.export_chrome_trace(str(trace_path))
    return {"window_s": end - start, "lat": lat, "rows": rows,
            "steps": steps, "failed": failed, "work": work, "walls": walls,
            "trace_path": trace_path}


def _read_trace(rec: Run, window: dict, dev_info: dict) -> dict:
    """Fill ``rec``'s device operations and profiled span from the
    profile; give ``dev_info`` busy_s and window_s; return the breakdown
    (the device operations that took the most time, the longest idle gaps
    named by the innermost program span open at their middle)."""
    events = devtrace.load(str(window["trace_path"]))
    marks = devtrace.markers(events, MARKER)
    if not marks:
        return {"device_ops": [], "idle_gaps": []}
    lo, hi = marks[0][0], marks[-1][1]
    ops = devtrace.clipped(devtrace.device_ops(events), lo, hi)
    rec.ops, rec.profiled = ops, (lo, hi)
    dev_info["busy_s"] = devtrace.busy_us(ops, lo, hi) / 1e6
    dev_info["window_s"] = (hi - lo) / 1e6
    # host wall clock -> trace clock, from each marker's start
    offset = statistics.median(m[0] - w * 1e6
                               for m, w in zip(marks, window["walls"]))
    spans = [(s["t0"] * 1e6 + offset, s["t0"] * 1e6 + offset
              + s["dur_s"] * 1e6, name) for s, name in _ordinals(rec.spans)]
    top = sorted(devtrace.time_by_name(ops).items(), key=lambda kv: -kv[1])
    gaps = sorted(devtrace.gaps_us(ops, lo, hi), key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) / 2
        open_ = [s for s in spans if s[0] <= mid <= s[1]]
        name = max(open_)[2] if open_ else "between requests"
        named.append([name, (g1 - g0) / 1e6])
    return {"device_ops": [[n[:200], us / 1e6] for n, us in top[:10]],
            "idle_gaps": named}


def _ordinals(spans: list[dict]):
    """(span, its name with ``#k`` for the k-th span of that name in its
    trace, k >= 2): the coordinator's fallback round is the second
    ``query.partial`` of a batch."""
    seen: dict = {}
    for s in sorted(spans, key=lambda s: s["t0"]):
        k = seen[(s["trace"], s["name"])] = \
            seen.get((s["trace"], s["name"]), 0) + 1
        yield s, s["name"] if k == 1 else f"{s['name']}#{k}"


def forbidden_modules(names=None) -> list[str]:
    """Top-level names, compared whole, of the loaded modules (or of
    ``names``) that the benchmark must not load."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def print_result(out: dict, trace: bool) -> None:
    """stderr: the peaks of a traced run, then, as the last lines, each
    compared number beside its limit; stdout: the result line last."""
    notes = out.pop("_notes")
    print(f"[portbench] seed {notes['seed']}, {notes['seconds']} s; set-up "
          f"{notes['setup']}; checked {notes['checked']} in "
          f"{notes['check_s']:.3f} s; program {notes['program']}; "
          f"batch ms {notes['latency_ms']}",
          file=sys.stderr)
    if trace:
        peak = roofline.peaks(out["device"]["kind"])
        if peak:
            print(f"[portbench] rooflines divide by "
                  f"{peak['int32_ops_per_s']:.4g} int32 op/s and "
                  f"{peak['bytes_per_s']:.4g} B/s ({peak['source']}); "
                  f"card: {power_limit()}", file=sys.stderr)
        else:
            print("[portbench] no peaks for this card: rooflines silent",
                  file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()


def cache_dirs(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout (the
    port builds into ``src/repro_torch/build/`` itself)."""
    cache = root / BENCH.name / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
