"""Readings of the check's control on the card, at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 5 [--b 8]

Runs the cell once a seed in this one process (set-up, a short window at
the cell's own load, the check) with the service on the program's own
b-bit path (``SearchConfig.b``) in place of the configuration's, and
prints each seed's compared numbers.  Without ``--b`` it reads sound
runs.  The benchmark's own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--b", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    harness.cache_dirs(ROOT)
    program = {} if args.b is None else {"b": args.b}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(ROOT, args.workload, seed, args.seconds, False,
                          device="cuda", overrides={"program": program})
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": program, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": {k: c["value"]
                                     for k, c in out["checks"].items()},
                          "checked": out["_notes"]["checked"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
