"""The control: the reference put in the program's place, computed in the
precision below the configuration's (bfloat16 for float32 scores), driven
through a cell's own traffic, set-up and window and judged by the same
comparison.  It has to come out not correct; its readings are the upper
ends the limits are set below.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 --seconds 8

Prints one line a seed with every compared number.  The benchmark's own
runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--dtype", default="bfloat16")
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)        # the repository, not this folder
    import torch

    from bench import harness
    from bench.systems import Control
    dtype = getattr(torch, args.dtype)
    c = harness.cell(args.workload)

    def make(cfg, tr, names):
        return Control(cfg, tr, dtype)

    failed = 0
    for seed in args.seeds:
        out = harness.run_cell(c, seed, args.seconds, False, "cpu",
                               system=make,
                               log=lambda *a, **k: None)
        out.pop("_runs")
        failed += not out["correct"]
        print(json.dumps({"workload": c.name, "seed": seed,
                          "dtype": args.dtype, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    print(f"control {args.dtype}: {failed} of {len(args.seeds)} runs not "
          f"correct", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
