"""Parser for the repo's thread-safety annotation comments.

The concurrent modules annotate their shared state in source comments, in
the spirit of Clang's thread-safety attributes (there is no runtime cost
and no import-order coupling — the lint reads the source, not the objects):

``self.x = ...  # guarded_by: _lock``
    every load/store of ``self.x`` outside ``__init__`` must happen inside
    ``with self._lock:`` (or in a method annotated ``# requires: _lock``);

``def m(self):  # requires: _lock``
    callers must hold ``self._lock``; the lint checks ``self.m()`` call
    sites within the module and treats the lock as held inside ``m``;

``self.x = ...  # published``
    a lock-free single-writer publication field: it may be (re)assigned by
    exactly one plain ``self.x = value`` per function (multi-field or
    multi-step publications are not atomic), and any reader must load it
    at most once per function (a second load can observe a different
    reference — a torn read);

``self.x = ...  # writer_only``
    touched only by the single front-door writer thread: any access from a
    background-thread closure (a ``threading.Thread`` target) or a
    thread-pool lambda is a violation;

``self.x = ...  # gil_shared``
    a container mutated in place under the GIL and read concurrently: the
    *reference* must never be rebound outside ``__init__`` (readers hold
    the reference; rebinding would split the fleet's view).

Annotations live on the line of the assignment (or anywhere within a
multi-line assignment statement); ``# requires:`` may sit on the ``def``
line or on the line directly above the method (above its decorators).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

_ANN_RE = re.compile(
    r"#\s*(guarded_by|requires|published|writer_only|gil_shared)\b"
    r"\s*:?\s*([A-Za-z0-9_,\s]*)")

GUARDED_BY = "guarded_by"
REQUIRES = "requires"
PUBLISHED = "published"
WRITER_ONLY = "writer_only"
GIL_SHARED = "gil_shared"


@dataclass
class ModuleAnnotations:
    """Per-class annotation tables for one source file."""

    # (class, field) -> lock name
    guards: dict[tuple[str, str], str] = field(default_factory=dict)
    published: set[tuple[str, str]] = field(default_factory=set)
    writer_only: set[tuple[str, str]] = field(default_factory=set)
    gil_shared: set[tuple[str, str]] = field(default_factory=set)
    # (class, method) -> set of lock names
    requires: dict[tuple[str, str], set[str]] = field(default_factory=dict)

    def field_kind(self, cls: str, name: str) -> str | None:
        if (cls, name) in self.guards:
            return GUARDED_BY
        if (cls, name) in self.published:
            return PUBLISHED
        if (cls, name) in self.writer_only:
            return WRITER_ONLY
        if (cls, name) in self.gil_shared:
            return GIL_SHARED
        return None

    @property
    def empty(self) -> bool:
        return not (self.guards or self.published or self.writer_only
                    or self.gil_shared or self.requires)


def _line_annotations(source: str) -> dict[int, tuple[str, str]]:
    """line number -> (kind, argument) for every annotation comment."""
    out: dict[int, tuple[str, str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        if "#" not in line:
            continue
        m = _ANN_RE.search(line)
        if m:
            out[i] = (m.group(1), m.group(2).strip())
    return out


def _self_targets(stmt: ast.stmt) -> list[str]:
    """Attribute names assigned via ``self.<name> = ...`` in a statement."""
    targets: list[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    out = []
    for t in targets:
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self"):
            out.append(t.attr)
    return out


def parse(source: str) -> ModuleAnnotations:
    ann = ModuleAnnotations()
    lines = _line_annotations(source)
    if not lines:
        return ann
    tree = ast.parse(source)
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        for node in ast.walk(cls):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                decos = node.decorator_list
                head = decos[0].lineno if decos else node.lineno
                for ln in (node.lineno, head - 1):
                    kind_arg = lines.get(ln)
                    if kind_arg and kind_arg[0] == REQUIRES:
                        locks = {s.strip() for s in kind_arg[1].split(",")
                                 if s.strip()}
                        ann.requires.setdefault(
                            (cls.name, node.name), set()).update(locks)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
                kind_arg = next((lines[ln] for ln in span if ln in lines),
                                None)
                if kind_arg is None:
                    continue
                kind, arg = kind_arg
                for name in _self_targets(node):
                    key = (cls.name, name)
                    if kind == GUARDED_BY and arg:
                        ann.guards[key] = arg.split(",")[0].strip()
                    elif kind == PUBLISHED:
                        ann.published.add(key)
                    elif kind == WRITER_ONLY:
                        ann.writer_only.add(key)
                    elif kind == GIL_SHARED:
                        ann.gil_shared.add(key)
    return ann


__all__ = ["ModuleAnnotations", "parse", "GUARDED_BY", "REQUIRES",
           "PUBLISHED", "WRITER_ONLY", "GIL_SHARED"]
