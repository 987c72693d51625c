"""Extensible-list growth strategies (paper §2.5, §5.3, §5.4).

Each strategy answers one question: *given that the first z blocks of a chain
are full and hold n payload bytes in total, how big should block z+1 be?*

  * ``Const(B)``    — Eq. 3:  B_{z+1} = B                       (paper §3)
  * ``Expon(B, k)`` — Eq. 5:  B_{z+1} = B*ceil((h+(k-1)n)/B)    (B&C 2005)
  * ``Triangle(B)`` — Eq. 6:  B_{z+1} = B*ceil((h+sqrt(2hn))/B) (paper §5.4)

All sizes are B-aligned multiples of the base block size, minimum B, and for
the variable strategies capped at 2^16 bytes with z capped at 256 (paper §5.4:
"block sizes capped at 2^16 bytes ... z a one-byte integer and capped at 256").

The key property (paper Eq. 1, Eq. 2, Figure 7):

  * Const/Expon overhead (links + tail wastage) is Θ(n);
  * Triangle overhead is Θ(sqrt(n)) — at n payload bytes the next block is
    ~sqrt(2hn), so links + expected half-empty tail are both O(sqrt(n)).

Because n is defined as the sum of *payload capacities* of completed blocks,
the whole size sequence is a pure function of z — both the writer (block
allocation) and the reader (finding where a full block ends) recompute it
deterministically from the 1-byte z field in the head block.  We memoise the
schedule per (strategy, B, h).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

MAX_BLOCK_BYTES = 1 << 16
MAX_Z = 256


@dataclass(frozen=True)
class GrowthPolicy:
    """Base class: subclasses define next_size(n, h) for the raw (unaligned)
    target; ``schedule`` materializes the B-aligned deterministic sequence."""

    B: int  # base (and minimum) block size in bytes
    name: str = "base"

    def is_const(self) -> bool:
        return False

    def _raw_next(self, n: int, h: int) -> float:
        raise NotImplementedError

    def block_size(self, z: int, h: int) -> int:
        """Size in bytes of the z-th block (1-based) of a chain."""
        return self.schedule(h)[min(z, MAX_Z) - 1]

    def schedule(self, h: int):
        """Deterministic per-z block sizes, computed once and cached."""
        key = ("_sched", h)
        cached = _SCHED_CACHE.get((self.name, self.B, h))
        if cached is not None:
            return cached
        sizes = [self.B]  # B_1 = B always
        n = self.B - h  # payload capacity accumulated so far
        for _ in range(MAX_Z - 1):
            raw = self._raw_next(n, h)
            aligned = self.B * max(1, math.ceil(raw / self.B))
            aligned = min(aligned, MAX_BLOCK_BYTES)
            sizes.append(aligned)
            n += aligned - h
        _SCHED_CACHE[(self.name, self.B, h)] = tuple(sizes)
        return _SCHED_CACHE[(self.name, self.B, h)]


_SCHED_CACHE: dict = {}


@dataclass(frozen=True)
class Const(GrowthPolicy):
    """Fixed-size blocks (Eq. 3).  Asymptotic overhead ratio h/(B-h)."""

    name: str = "const"

    def is_const(self) -> bool:
        return True

    def _raw_next(self, n: int, h: int) -> float:
        return self.B


@dataclass(frozen=True)
class Expon(GrowthPolicy):
    """Geometric growth (Eq. 5) with rate k; B&C favoured k = 1.1."""

    k: float = 1.1
    name: str = "expon"

    def _raw_next(self, n: int, h: int) -> float:
        return h + (self.k - 1.0) * n


@dataclass(frozen=True)
class Triangle(GrowthPolicy):
    """The paper's new strategy (Eq. 6): B_{z+1} ≈ h + sqrt(2 h n).

    Matches Eq. 2's optimum B = sqrt(2hn): at every moment the link overhead
    (~h n / B) and expected tail wastage (~B/2) are balanced, giving total
    overhead Θ(sqrt(n)) ∈ o(n) — strictly better asymptotics than any
    constant-ratio scheme.
    """

    name: str = "triangle"

    def _raw_next(self, n: int, h: int) -> float:
        return h + math.sqrt(2.0 * h * n)


def make_policy(name: str, B: int, k: float = 1.1) -> GrowthPolicy:
    name = name.lower()
    if name == "const":
        return Const(B=B)
    if name == "expon":
        return Expon(B=B, k=k)
    if name == "triangle":
        return Triangle(B=B)
    raise ValueError(f"unknown growth policy {name!r}")


def overhead_model(policy: GrowthPolicy, n: int, h: int) -> dict:
    """Analytic overhead (links + tail slack) if a chain holds exactly n
    payload bytes — used by tests to verify the Θ(sqrt(n)) vs Θ(n) claim.

    Beyond MAX_Z blocks the chain keeps allocating at the final (capped)
    size, matching the writer/reader saturation behaviour (§5.4)."""
    sizes = policy.schedule(h)
    total_payload = 0
    links = 0
    z = 0
    while total_payload < n:
        cap = sizes[min(z, MAX_Z - 1)] - h
        total_payload += cap
        links += h
        z += 1
    slack = total_payload - n
    return {"blocks": z, "link_bytes": links, "tail_slack": slack,
            "overhead": links + slack, "ratio": (links + slack) / max(n, 1)}
