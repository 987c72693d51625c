"""The command line: ``python -m repro_torch.analysis``.

Gathers the port's own layout (the six concurrent modules for the
lock-discipline lint, every ``src/repro_torch`` module outside
``analysis/`` for the cursor scan, the ``kernels/`` tree for layout and
purity, ``serve/workload.py`` for schedule purity), applies the allowlist,
prints one line per finding (``path:line: [check] message  (ident)``) and
exits non-zero if anything unsuppressed remains — including stale
allowlist entries, so reviewed exceptions cannot outlive the code they
excused.

The allowlist is ``src/repro_torch/analysis/allowlist.txt``, not the
reference's root ``analysis_allowlist.txt``: each CLI fails on the other's
entries as stale, so the two never share a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import locks, protocol, purity
from .report import Allowlist, Finding, apply_allowlist

# The modules with cross-thread state; the lock lint runs ONLY where the
# annotation discipline is in force (everything else is single-threaded).
CONCURRENT_MODULES = [
    "src/repro_torch/core/lifecycle.py",
    "src/repro_torch/engine/engine.py",
    "src/repro_torch/engine/device_backend.py",
    "src/repro_torch/serve/query_service.py",
    "src/repro_torch/serve/ingest_pipeline.py",
    "src/repro_torch/core/sharded_index.py",
]

# Workload-schedule generators: must be pure functions of their seed (the
# traffic harness's determinism contract) — import-surface lint only.
SCHEDULE_MODULES = [
    "src/repro_torch/serve/workload.py",
]

#: kernel flavour modules the purity lint reads (``ref.py`` for the
#: determinism rules only, see :mod:`.purity`)
FLAVOR_MODULES = ("ref.py", "kernel.py", "ops.py")

DEFAULT_ALLOWLIST = "src/repro_torch/analysis/allowlist.txt"


def _repo_root() -> str:
    # src/repro_torch/analysis/__main__.py -> repo root is four levels up
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _python_files(root: str, subdir: str) -> list[tuple[str, str]]:
    out = []
    base = os.path.join(root, subdir)
    for dirpath, _dirnames, filenames in os.walk(base):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                out.append((path, os.path.relpath(path, root)))
    return sorted(out, key=lambda p: p[1])


def collect_findings(root: str) -> list[Finding]:
    findings: list[Finding] = []

    lock_files = [(os.path.join(root, rel), rel)
                  for rel in CONCURRENT_MODULES
                  if os.path.exists(os.path.join(root, rel))]
    findings.extend(locks.run(lock_files))

    src_files = _python_files(root, os.path.join("src", "repro_torch"))
    cursor_files = [(p, rel) for p, rel in src_files
                    if os.sep + "analysis" + os.sep not in p]
    findings.extend(protocol.check_cursors(cursor_files))

    kernels_dir = os.path.join(root, "src", "repro_torch", "kernels")
    if os.path.isdir(kernels_dir):
        findings.extend(protocol.check_kernels(kernels_dir, root))
        flavor_files = [
            (p, rel) for p, rel in _python_files(
                root, os.path.join("src", "repro_torch", "kernels"))
            if os.path.basename(p) in FLAVOR_MODULES]
        findings.extend(purity.run(flavor_files))

    for rel in SCHEDULE_MODULES:
        path = os.path.join(root, rel)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                findings.extend(purity.check_schedule_module(fh.read(), rel))

    return sorted(findings, key=lambda f: (f.path, f.line, f.symbol))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant checker for the PyTorch/CUDA port")
    ap.add_argument("--root", default=_repo_root(),
                    help="repo root (default: inferred from the package)")
    ap.add_argument("--allowlist", default=None,
                    help=f"allowlist file (default: <root>/"
                         f"{DEFAULT_ALLOWLIST} if present)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON records")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    allow_path = args.allowlist or os.path.join(root, DEFAULT_ALLOWLIST)
    allowlist = Allowlist.load(allow_path) \
        if os.path.exists(allow_path) else None

    findings = collect_findings(root)
    reported = apply_allowlist(findings, allowlist)
    suppressed = len(findings) - len(reported)
    stale = allowlist.stale() if allowlist else []

    if args.json:
        print(json.dumps({
            "findings": [{"check": f.check, "path": f.path, "line": f.line,
                          "symbol": f.symbol, "ident": f.ident,
                          "message": f.message} for f in reported],
            "suppressed": suppressed,
            "stale_allowlist": stale,
        }, indent=2))
    else:
        for f in reported:
            print(f)
        for ident in stale:
            print(f"stale allowlist entry (matched nothing): {ident}")
        tail = f"{len(reported)} finding(s)"
        if suppressed:
            tail += f", {suppressed} suppressed by allowlist"
        if stale:
            tail += f", {len(stale)} stale allowlist entr(y/ies)"
        print(f"repro_torch.analysis: {tail}")

    return 1 if (reported or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
