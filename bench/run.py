"""Run one cell of the benchmark once, on the card, and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Measures ``repro_torch`` (under ``src/``) only.  The last line of standard
output is the result's JSON object; the numbers compared with the
reference, each beside its limit, are the last lines of standard error.
Exits with a code other than 0, printing no result, where there is no CUDA
card or fewer than the cell asks for, or where the JAX package or JAX is
loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # build caches at fixed paths inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[0] = str(ROOT)        # the repository, not this folder
    sys.path.insert(1, str(ROOT / "src"))

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    from bench import check, harness
    c = harness.cell(args.workload)
    if torch.cuda.device_count() < c.chips:
        print(f"{c.name} needs {c.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    card = harness.power_limit()
    out = harness.run_cell(c, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START,
                           log=lambda *a, **k: print(*a, file=sys.stderr))
    runs = out.pop("_runs")
    out["device"]["power_limit"] = card
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for run in runs:
        counters = {k: run.counter(k) for k in run.counters_end}
        print(f"run {c.name} seed {args.seed}: setup_s {run.setup_s!r} "
              f"({run.setup_phases}; the kernel built in this run: "
              f"{out['compiled']}), window {run.window_s!r} s, "
              f"{len(run.batches)} batches, {run.queries} queries "
              f"(a second by quarter: {run.quarter_rates()}), "
              f"{run.docs_ingested} documents and {run.deletes} deletes, "
              f"backends {run.backends}, counters {counters}, footprint "
              f"{run.footprint} ({card})", file=sys.stderr)
    checks = out["checks"]
    for line in check.lines({k: v["value"] for k, v in checks.items()},
                            {k: v["limit"] for k, v in checks.items()}):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
