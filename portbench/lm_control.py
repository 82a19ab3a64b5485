"""Readings of an LM cell's check on the card, with a control: the
output of every MoE layer rounded to a lower precision, or the Mamba
scan's state held in one.

    python3 portbench/lm_control.py --workload <name> --seeds 1,2,3 --seconds 5 [--expert-dtype float8_e4m3fn] [--ssm-scan-dtype bfloat16]

Runs the cell once a seed in this one process (set-up, a short window,
the check) and prints each seed's compared numbers and what they were
computed from (each checked row's largest logit error and token gap).
Without either option it reads sound runs.  The benchmark's own runs
never run it.
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
    ap.add_argument("--expert-dtype", default=None)
    ap.add_argument("--ssm-scan-dtype", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    harness.cache_dirs(ROOT)
    program = {k: v for k, v in (("expert_dtype", args.expert_dtype),
                                 ("ssm_scan_dtype", args.ssm_scan_dtype))
               if v is not None}
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
