"""repro_torch.analysis — the port's static invariant checker and runtime
concurrency sanitizer.

Run the static pass over the port::

    python -m repro_torch.analysis [--root DIR] [--allowlist FILE] [--json]

Checks (see each module's docstring for the full contract):

* :mod:`.locks`     — lock-discipline lint over the port's annotated
  concurrent modules (``guarded_by`` / ``requires`` / ``published`` /
  ``writer_only`` / ``gil_shared``, see :mod:`.annotations`);
* :mod:`.protocol`  — cursor-protocol conformance for every class exposing
  ``next``/``seek_geq``, and kernel-package conformance: layout (``ref``,
  ``kernel``, ``ops`` and the ``csrc/`` CUDA source), ``kernels/build.py``
  ``SOURCES`` and the registry, ref↔kernel signatures;
* :mod:`.purity`    — kernel purity in eager torch's terms (no host syncs,
  no data-sized outputs, no branching on a tensor's value in the launch
  wrappers and dispatchers; no clocks or randomness in any flavour).

Runtime companions:

* :class:`.contracts.ContractCursor` — contract-asserting cursor proxy
  used by the differential tests;
* :class:`.sanitizer.Sanitizer` — instrumented locks (lock-order
  inversion detection) + Eraser-style field race detection, which
  ``chip_smoke.py`` runs over a fleet on the card.

The package is a copy of the reference's ``repro.analysis`` with its
rules re-written for the port, and imports nothing of it.  Exit status of
the CLI is non-zero iff unsuppressed findings (or stale allowlist entries)
exist; reviewed exceptions live in ``src/repro_torch/analysis/
allowlist.txt``, one stable ident per line.
"""

from . import annotations, locks, protocol, purity
from .contracts import ContractCursor, ContractViolation, wrap
from .report import Allowlist, Finding, apply_allowlist
from .sanitizer import Sanitizer, env_enabled

__all__ = [
    "annotations", "locks", "protocol", "purity",
    "ContractCursor", "ContractViolation", "wrap",
    "Allowlist", "Finding", "apply_allowlist",
    "Sanitizer", "env_enabled",
]
