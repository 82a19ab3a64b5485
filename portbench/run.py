"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints each compared number beside its
limit as the last lines of standard error and the result as one JSON
object, the last line of standard output.  Exits 2 without a result where
no CUDA card (or too few for the cell) is present, 3 where a module of JAX
or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def pin_cores() -> list[int]:
    """Keep this process (and the threads it starts later) on four fixed
    cores, the third to the sixth it may use: unpinned, a one-card
    machine's host noise spread the batch tail of runs of one seed over a
    third."""
    cores = sorted(os.sched_getaffinity(0))
    pick = cores[2:6] if len(cores) >= 6 else cores[-4:]
    os.sched_setaffinity(0, pick)
    return pick


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_cores()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    harness.cache_dirs(ROOT)
    cell = harness.find_cell(harness.load_manifest(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"[portbench] {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"[portbench] loaded modules the benchmark must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    harness.print_result(out, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
