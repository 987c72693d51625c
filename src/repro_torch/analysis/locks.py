"""Lock-discipline lint (AST, Clang-thread-safety style) for the engine's
concurrent modules.

What it enforces, per :mod:`repro_torch.analysis.annotations`:

* ``guarded_by`` fields are only touched inside ``with self.<lock>:`` or in
  methods annotated ``requires: <lock>`` (``__init__`` is exempt — the
  object is not shared yet);
* ``requires``-annotated methods are only called (as ``self.m()``, within
  the module) where the lock is held;
* ``published`` fields follow the single-writer lock-free publication
  protocol: one plain reference assignment per function (no multi-field
  publications, which are not atomic), at most one load per function (two
  loads can straddle a concurrent swap — a torn read), and no
  read-modify-write from a background thread;
* ``writer_only`` fields are never touched from a thread-target closure or
  a pool lambda;
* ``gil_shared`` container fields are never rebound outside ``__init__``;
* unannotated fields are not *written* from more than one thread
  entry-point (writer methods vs. ``threading.Thread`` target closures vs.
  thread-pool lambdas) — shared mutation must be annotated to state its
  protection, or fixed.

Thread roles are inferred syntactically: a nested function passed as
``threading.Thread(target=...)`` runs on a background thread; a callable
passed to ``<pool>.map``/``<pool>.submit`` runs on a pool thread;
everything else runs on the caller (writer) thread.  The analysis is
module-local and flow-insensitive beyond ``with``-scope tracking — it is a
lint for this repo's one-writer architecture, not a general race prover.

It reads ``self.`` fields only.  State kept in module globals is out of its
reach: ``kernels/build.py`` keeps its loaded libraries in ``_LOADED``,
written under the module lock ``_LOAD_LOCK``.  The sanitizer covers that
one instead (``tests/test_torch_analysis.py``: eight threads make the
first load of a kernel with ``_LOAD_LOCK`` swapped for an instrumented
lock).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from . import annotations as ann_mod
from .report import Finding

ROLE_WRITER = "writer"
ROLE_THREAD = "thread-target"
ROLE_POOL = "pool"

CHECK = "lock-discipline"


@dataclass
class _Scope:
    cls: str
    func: str                       # dotted for nested: "freeze.work"
    role: str
    node: ast.AST                   # FunctionDef or Lambda
    held0: frozenset[str] = frozenset()


@dataclass
class _Access:
    field: str
    line: int
    is_store: bool
    is_aug: bool
    held: frozenset[str]


@dataclass
class _ScopeResult:
    scope: _Scope
    accesses: list[_Access] = field(default_factory=list)
    self_calls: list[tuple[str, int, frozenset]] = field(default_factory=list)


def _is_self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _thread_target_names(fn: ast.AST) -> set[str]:
    """Names of nested defs passed as ``threading.Thread(target=...)``."""
    out = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        callee = node.func
        is_thread = (isinstance(callee, ast.Attribute)
                     and callee.attr == "Thread") or \
                    (isinstance(callee, ast.Name) and callee.id == "Thread")
        if not is_thread:
            continue
        for kw in node.keywords:
            if kw.arg == "target" and isinstance(kw.value, ast.Name):
                out.add(kw.value.id)
    return out


def _pool_callables(fn: ast.AST) -> tuple[set[int], set[str]]:
    """(lambda node ids, nested-def names) handed to ``.map``/``.submit``."""
    lambda_ids: set[int] = set()
    names: set[str] = set()
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("map", "submit") and node.args):
            continue
        head = node.args[0]
        if isinstance(head, ast.Lambda):
            lambda_ids.add(id(head))
        elif isinstance(head, ast.Name):
            names.add(head.id)
    return lambda_ids, names


class _Walker:
    """One function scope: track ``with self.<lock>`` nesting, record every
    ``self.<attr>`` access with the lock set held at that point."""

    def __init__(self, result: _ScopeResult, pool_lambda_ids: set[int]):
        self.res = result
        self.pool_lambda_ids = pool_lambda_ids

    # -- statements --------------------------------------------------------

    def walk_body(self, body: list[ast.stmt], held: frozenset[str]) -> None:
        for stmt in body:
            self.walk_stmt(stmt, held)

    def walk_stmt(self, stmt: ast.stmt, held: frozenset[str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                      # nested defs are separate scopes
        if isinstance(stmt, ast.With):
            new_held = set(held)
            for item in stmt.items:
                self.walk_expr(item.context_expr, held)
                lock = _is_self_attr(item.context_expr)
                if lock is not None:
                    new_held.add(lock)
            self.walk_body(stmt.body, frozenset(new_held))
            return
        if isinstance(stmt, ast.Assign):
            self.walk_expr(stmt.value, held)
            for t in stmt.targets:
                self._store_target(t, held, aug=False)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self.walk_expr(stmt.value, held)
            self._store_target(stmt.target, held, aug=False)
            return
        if isinstance(stmt, ast.AugAssign):
            self.walk_expr(stmt.value, held)
            self._store_target(stmt.target, held, aug=True)
            return
        # generic recursion: visit child expressions, then child bodies
        for fld, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                self.walk_expr(value, held)
            elif isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    self.walk_body(value, held)
                else:
                    for v in value:
                        if isinstance(v, ast.expr):
                            self.walk_expr(v, held)
                        elif isinstance(v, ast.excepthandler):
                            self.walk_body(v.body, held)

    def _store_target(self, target: ast.expr, held: frozenset[str],
                      aug: bool) -> None:
        name = _is_self_attr(target)
        if name is not None:
            self.res.accesses.append(_Access(name, target.lineno, True, aug,
                                             held))
            if aug:     # augmented store is also a load
                self.res.accesses.append(_Access(name, target.lineno, False,
                                                 True, held))
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._store_target(el, held, aug)
            return
        self.walk_expr(target, held)    # self.a[i] = x loads self.a

    # -- expressions -------------------------------------------------------

    def walk_expr(self, expr: ast.expr, held: frozenset[str]) -> None:
        if isinstance(expr, ast.Lambda):
            if id(expr) in self.pool_lambda_ids:
                return                  # separate pool-role scope
            self.walk_expr(expr.body, held)
            return
        name = _is_self_attr(expr)
        if name is not None:
            self.res.accesses.append(
                _Access(name, expr.lineno, False, False, held))
            self.walk_expr(expr.value, held)
            return
        if (isinstance(expr, ast.Call)
                and (callee := _is_self_attr(expr.func)) is not None):
            self.res.self_calls.append((callee, expr.lineno, held))
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                self.walk_expr(child, held)
            elif isinstance(child, ast.comprehension):
                self.walk_expr(child.iter, held)
                self.walk_expr(child.target, held)
                for cond in child.ifs:
                    self.walk_expr(cond, held)


def _collect_scopes(cls: ast.ClassDef,
                    ann: ann_mod.ModuleAnnotations) -> list[_ScopeResult]:
    out = []
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        targets = _thread_target_names(method)
        pool_lambdas, pool_names = _pool_callables(method)
        held0 = frozenset(ann.requires.get((cls.name, method.name), set()))
        scopes = [_Scope(cls.name, method.name, ROLE_WRITER, method, held0)]
        for node in ast.walk(method):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not method:
                role = ROLE_THREAD if node.name in targets else (
                    ROLE_POOL if node.name in pool_names else ROLE_WRITER)
                scopes.append(_Scope(cls.name, f"{method.name}.{node.name}",
                                     role, node))
            elif isinstance(node, ast.Lambda) and id(node) in pool_lambdas:
                scopes.append(_Scope(cls.name, f"{method.name}.<lambda>",
                                     ROLE_POOL, node))
        for scope in scopes:
            res = _ScopeResult(scope)
            walker = _Walker(res, pool_lambdas)
            body = scope.node.body
            if isinstance(body, list):
                walker.walk_body(body, scope.held0)
            else:                       # Lambda body is a single expression
                walker.walk_expr(body, scope.held0)
            out.append(res)
    return out


def check_module(path: str, source: str, relpath: str) -> list[Finding]:
    ann = ann_mod.parse(source)
    tree = ast.parse(source)
    findings: list[Finding] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        results = _collect_scopes(cls, ann)
        # field -> {role: first store line} across all non-__init__ scopes
        store_roles: dict[str, dict[str, int]] = {}
        for res in results:
            sc = res.scope
            in_init = sc.func.split(".")[0] == "__init__"
            loads: dict[str, list[int]] = {}
            stores: dict[str, list[int]] = {}
            for acc in res.accesses:
                kind = ann.field_kind(cls.name, acc.field)
                if acc.is_store:
                    stores.setdefault(acc.field, []).append(acc.line)
                    if kind is None and not in_init:
                        store_roles.setdefault(acc.field, {}) \
                            .setdefault(sc.role, acc.line)
                else:
                    loads.setdefault(acc.field, []).append(acc.line)
                if kind is None or in_init:
                    continue
                sym = f"{cls.name}.{sc.func}.{acc.field}"
                if kind == ann_mod.GUARDED_BY:
                    lock = ann.guards[(cls.name, acc.field)]
                    if lock not in acc.held:
                        verb = "write" if acc.is_store else "read"
                        findings.append(Finding(
                            CHECK, relpath, acc.line, sym,
                            f"{verb} of '{acc.field}' (guarded_by {lock}) "
                            f"outside 'with self.{lock}:' in "
                            f"{cls.name}.{sc.func}"))
                elif kind == ann_mod.WRITER_ONLY \
                        and sc.role != ROLE_WRITER:
                    findings.append(Finding(
                        CHECK, relpath, acc.line, sym,
                        f"writer_only field '{acc.field}' touched from a "
                        f"{sc.role} scope {cls.name}.{sc.func}"))
                elif kind == ann_mod.GIL_SHARED and acc.is_store:
                    findings.append(Finding(
                        CHECK, relpath, acc.line, sym,
                        f"gil_shared container '{acc.field}' rebound outside "
                        f"__init__ in {cls.name}.{sc.func} (readers hold the "
                        f"old reference)"))
                elif kind == ann_mod.PUBLISHED and acc.is_store \
                        and acc.is_aug and sc.role != ROLE_WRITER:
                    findings.append(Finding(
                        CHECK, relpath, acc.line, sym,
                        f"read-modify-write of published field '{acc.field}' "
                        f"from a {sc.role} scope {cls.name}.{sc.func} — not "
                        f"atomic against the writer thread"))
            if in_init:
                continue
            # published-protocol rules, per scope
            pub_stored = sorted(
                f for f in stores
                if (cls.name, f) in ann.published)
            if len(pub_stored) > 1:
                line = max(stores[f][0] for f in pub_stored)
                findings.append(Finding(
                    CHECK, relpath, line,
                    f"{cls.name}.{sc.func}.{'+'.join(pub_stored)}",
                    f"non-atomic publication: {cls.name}.{sc.func} stores "
                    f"{len(pub_stored)} published fields "
                    f"({', '.join(pub_stored)}) — a reader between the "
                    f"stores sees them inconsistent; publish ONE immutable "
                    f"object by a single reference assignment"))
            for f, lns in stores.items():
                if (cls.name, f) in ann.published and len(lns) > 1:
                    findings.append(Finding(
                        CHECK, relpath, lns[1], f"{cls.name}.{sc.func}.{f}",
                        f"published field '{f}' stored {len(lns)} times in "
                        f"{cls.name}.{sc.func} — publication must be a "
                        f"single assignment"))
            for f, lns in loads.items():
                if (cls.name, f) in ann.published and len(lns) > 1:
                    findings.append(Finding(
                        CHECK, relpath, lns[1], f"{cls.name}.{sc.func}.{f}",
                        f"torn read: published field '{f}' loaded "
                        f"{len(lns)}x in {cls.name}.{sc.func} — a concurrent "
                        f"swap between loads yields mixed state; snapshot it "
                        f"once into a local"))
            # requires-annotated self-calls need the lock at the call site
            for callee, line, held in res.self_calls:
                need = ann.requires.get((cls.name, callee), set())
                missing = sorted(need - held)
                if missing:
                    findings.append(Finding(
                        CHECK, relpath, line,
                        f"{cls.name}.{sc.func}.{callee}()",
                        f"call to {cls.name}.{callee}() (requires "
                        f"{', '.join(missing)}) without holding the lock in "
                        f"{cls.name}.{sc.func}"))
        for f, roles in store_roles.items():
            if len(roles) > 1:
                line = min(roles.values())
                findings.append(Finding(
                    CHECK, relpath, line, f"{cls.name}.{f}",
                    f"unannotated field '{cls.name}.{f}' written from "
                    f"multiple thread entry-points ({', '.join(sorted(roles))})"
                    f" — annotate its protection (guarded_by/published) or "
                    f"serialize the writers"))
    return findings


def run(files: list[tuple[str, str]]) -> list[Finding]:
    """files: (absolute path, repo-relative path) pairs."""
    findings = []
    for path, rel in files:
        with open(path, encoding="utf-8") as fh:
            findings.extend(check_module(path, fh.read(), rel))
    return findings


__all__ = ["run", "check_module", "CHECK"]
