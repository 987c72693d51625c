"""Findings, stable identifiers, and the reviewed-exception allowlist.

Every check in :mod:`repro_torch.analysis` reports :class:`Finding` records.  A
finding carries two addresses:

* ``path:line`` — where a human looks (printed, asserted by the tests);
* ``ident``     — a *stable* identifier (``check:file:symbol``) that does
  NOT include the line number, so an allowlist entry survives unrelated
  edits above it.  The allowlist file holds one ident per line
  (``#`` comments allowed); entries that match nothing are reported as
  stale so reviewed exceptions cannot silently outlive their reason.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    check: str          # e.g. "lock-discipline", "protocol", "kernel-purity"
    path: str           # repo-relative file path
    line: int
    symbol: str         # stable symbol, e.g. "FreezeManager.suffix_size.tier"
    message: str

    @property
    def ident(self) -> str:
        return f"{self.check}:{self.path}:{self.symbol}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}" \
               f"  ({self.ident})"


@dataclass
class Allowlist:
    """Reviewed exceptions: idents suppressed from the report."""

    entries: set[str] = field(default_factory=set)
    used: set[str] = field(default_factory=set)

    @classmethod
    def load(cls, path) -> "Allowlist":
        entries = set()
        with open(path, encoding="utf-8") as fh:
            for raw in fh:
                line = raw.split("#", 1)[0].strip()
                if line:
                    entries.add(line)
        return cls(entries=entries)

    def suppresses(self, finding: Finding) -> bool:
        if finding.ident in self.entries:
            self.used.add(finding.ident)
            return True
        return False

    def stale(self) -> list[str]:
        """Entries that matched no finding (the exception no longer exists)."""
        return sorted(self.entries - self.used)


def apply_allowlist(findings: list[Finding],
                    allowlist: Allowlist | None) -> list[Finding]:
    if allowlist is None:
        return list(findings)
    return [f for f in findings if not allowlist.suppresses(f)]


__all__ = ["Finding", "Allowlist", "apply_allowlist"]
