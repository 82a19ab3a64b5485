#!/usr/bin/env python3
"""Times the top-k select kernel (``src/repro_torch/csrc/topk_select.cu``)
alone on an NVIDIA card, at the brute-force fallback's shapes in the two
benchmark cells and at web's with top_k 40 (two passes of the kernel),
beside its bound (bytes / 3.35 TB/s, the counts read once) and the plain
version (the full stable sort of ``-counts`` and the gather); the kernel
must equal the plain version on every input.

    python3 time_topk_select.py        # from the root of a checkout

Counts are drawn two ways: ``ties`` (0-39, as collision counts of novel
pages tie) and ``wide`` (0 to 2^30, almost no ties: more list inserts).
``ms`` times the call with the host's launch work, ``device_ms`` the card's
work alone (``chip_smoke.time_ms``); the counts (1.3 GB and 139 MB) do not
fit in L2.  Prints one line per case and writes
``chiprun_out/topk_select_timing.json``.
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import bound_ms, card_line, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import topk_select as kt  # noqa: E402

# (cell, real fallback rows, index rows, top_k): a web batch sends ~1,240
# of its 2,048 rows to the fallback (`fallback_useful_pct` ~60.6),
# MovieLens all 500; top_k 40 is no cell's, the kernel's two-pass case.
SHAPES = (("web_crawl_mixed", 1240, 262_144, 5),
          ("ml10m_knn", 500, 69_363, 10),
          ("web_crawl_mixed", 1240, 262_144, 40))
DISTS = {"ties": 40, "wide": 1 << 30}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("time_topk_select: needs an NVIDIA card")
    card = card_line()
    built = _build.build(["topk_select"])["topk_select"]
    print(f"[card] {card}; torch {torch.__version__}; build "
          f"{built['seconds']:.2f} s")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    rows = []
    for cell, q, u, kk in SHAPES:
        for dist, hi in DISTS.items():
            gen = torch.Generator(device="cuda").manual_seed(q + hi)
            counts = torch.randint(0, hi, (q, u), generator=gen,
                                   device="cuda", dtype=torch.int32)
            got = kt.topk_select_kernel(counts, kk)
            torch.cuda.synchronize()
            want = kt.topk_select_plain(counts, kk)
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            n_bytes = q * u * 4 + q * kk * (4 + 8)
            bound, by = bound_ms(n_bytes, q * u)
            row = {"cell": cell, "dist": dist, "q": q, "u": u, "kk": kk,
                   "equal": equal,
                   "ms": time_ms(lambda: kt.topk_select_kernel(counts, kk),
                                 20),
                   "device_ms": time_ms(
                       lambda: kt.topk_select_kernel(counts, kk), 20,
                       spin=True),
                   "plain_ms": time_ms(
                       lambda: kt.topk_select_plain(counts, kk), 5),
                   "bound_ms": bound, "bound_by": by, "card": card}
            rows.append(row)
            print(json.dumps(row))
            del counts, got, want
            torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "topk_select_timing.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    if not all(r["equal"] for r in rows):
        sys.exit("time_topk_select: the kernel differs from the plain version")


if __name__ == "__main__":
    main()
