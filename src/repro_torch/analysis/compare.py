"""Compare two dry-run sweeps (baseline vs optimized) per cell: a copy of
``repro.analysis.compare`` over this package's roofline.

    PYTHONPATH=src python -m repro_torch.analysis.compare \
        --baseline runs/dryrun --optimized runs/dryrun_opt --mesh single_pod
"""

from __future__ import annotations

import argparse

from .roofline import load_records, roofline, _fmt_s


def compare(base_dir: str, opt_dir: str, mesh: str) -> str:
    base = {(r["arch"], r["shape"]): r for r in load_records(base_dir, mesh)}
    opt = {(r["arch"], r["shape"]): r for r in load_records(opt_dir, mesh)}
    lines = [
        "| arch | shape | dominant | before | after | delta | term moved |",
        "|---|---|---|---|---|---|---|",
    ]
    for key in sorted(base):
        b, o = base.get(key), opt.get(key)
        if not b or not o or b["status"] != "ok" or o["status"] != "ok":
            continue
        tb, to = roofline(b), roofline(o)
        dom = tb["dominant"]
        before = tb[f"{dom}_s"]
        after = to[f"{dom}_s"]
        delta = (after - before) / before * 100 if before else 0.0
        if abs(delta) < 0.5:
            continue
        lines.append(
            f"| {key[0]} | {key[1]} | {dom} | {_fmt_s(before)} | "
            f"{_fmt_s(after)} | {delta:+.1f}% | "
            f"c {_fmt_s(tb['compute_s'])}->{_fmt_s(to['compute_s'])}, "
            f"m {_fmt_s(tb['memory_s'])}->{_fmt_s(to['memory_s'])}, "
            f"x {_fmt_s(tb['collective_s'])}->{_fmt_s(to['collective_s'])} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="runs/dryrun")
    ap.add_argument("--optimized", default="runs/dryrun_opt")
    ap.add_argument("--mesh", default="single_pod")
    args = ap.parse_args()
    print(compare(args.baseline, args.optimized, args.mesh))


if __name__ == "__main__":
    main()
