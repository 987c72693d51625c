"""Kernel purity lint for the port's kernel packages, in eager torch's terms.

A kernel flavour on the card's path must not stall the host on the card:
every host synchronization serializes the launch queue that the CUDA
kernels and the torch ops around them share.  The modules and the rules
that apply to each:

* ``kernels/*/kernel.py`` (the launch wrappers) and ``kernels/*/ops.py``
  (the dispatchers, on the card's path) — every rule below;
* ``kernels/*/ref.py`` (the plain versions) — the determinism rules only.
  The plain versions are oracles, run on the card only where
  ``chip_smoke.py`` holds a kernel against them; their per-segment loops
  (``fused_query/ref.py``, ``intersect/ref.py``, ``topk_score/ref.py``)
  read segment bounds to the host on purpose, to fix the order of the
  additions that the CUDA kernels keep.

The rules:

* host syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")`` / ``.to(device="cpu")``, ``torch.cuda.synchronize()`` and a
  stream's or event's ``.synchronize()``, and ``float(x)`` / ``int(x)`` /
  ``bool(x)`` of a traced value;
* ops whose output size depends on the data, which wait for the card to
  learn it: ``torch.nonzero`` / ``x.nonzero()``, ``torch.unique`` (and
  ``unique_consecutive``, ``argwhere``, ``masked_select``), and indexing
  (or assigning through) a boolean tensor;
* Python ``if`` / ``while`` / ternary / comprehension filter / ``assert``
  whose test is a traced value: a tensor's truth value is a host sync;
* determinism: no ``time`` / ``random`` / ``numpy.random`` import — a
  flavour is a deterministic function of its inputs.

Traced-ness is inferred conservatively, in the port's idiom.  A value is
*traced* (may be a tensor on the card) unless it is known to be a host
value.  Host values (*static*): parameters annotated ``int`` / ``bool`` /
``str`` / ``float``, ``X | None`` or ``Optional[X]`` of those (also as a
string annotation), and locals assigned under such an annotation; module
constants and imported names; tensor metadata, which eager torch keeps on
the host — ``.shape``, ``.ndim``, ``.dtype``, ``.device``, ``.is_cuda``,
``.numel()``, ``.dim()``, ``.size()``, ``.is_contiguous()``,
``.data_ptr()``, ``.element_size()``, ``.stride()``; ``isinstance`` and
``len()`` of anything; the index of ``enumerate``; ``x is None``;
arithmetic and comparisons of statics.  Any other call's result is traced.
Branching on statics (tile math, mode strings, an optional input's
None-ness, a tensor's device) is the normal idiom and passes.
"""

from __future__ import annotations

import ast
import os

from .report import Finding

CHECK = "kernel-purity"
SCHEDULE_CHECK = "schedule-purity"

_STATIC_ANNOTATIONS = {"int", "bool", "str", "float"}
#: tensor metadata attributes (host values in eager torch)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
#: tensor metadata methods (host values in eager torch)
_STATIC_METHODS = {"numel", "dim", "size", "is_contiguous", "data_ptr",
                   "element_size", "stride"}
#: builtins static whatever their argument
_ALWAYS_STATIC_CALLS = {"len", "isinstance"}
#: builtins static when every argument is (``x.sum()``, a method, is not)
_STATIC_CALLS = {"range", "min", "max", "abs", "sum", "tuple", "list",
                 "sorted", "enumerate", "zip", "divmod", "getattr",
                 "hasattr", "type", "repr", "str"}
#: dtype queries (``torch.iinfo(torch.int32).max``)
_STATIC_ATTR_CALLS = {"iinfo", "finfo"}
_CAST_CALLS = {"float", "int", "bool"}
#: method calls that copy a tensor to the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: calls whose output size depends on the data
_DATA_SIZED = {"nonzero", "unique", "unique_consecutive", "argwhere",
               "masked_select"}
#: calls and methods that return a boolean tensor from a traced input
_MASK_CALLS = {"isin", "isnan", "isinf", "isfinite", "logical_and",
               "logical_or", "logical_not", "logical_xor", "eq", "ne", "lt",
               "le", "gt", "ge", "bool"}
_FORBIDDEN_MODULES = {"time", "random", "numpy.random"}
#: modules held to the determinism rules only
_DETERMINISM_ONLY = {"ref.py"}


def _annotation_static(node: ast.expr | None) -> bool:
    """Whether an annotation names a host scalar type: ``int``, ``float``,
    ``X | None``, ``Optional[X]`` or the same as a string."""
    if node is None:
        return False
    if isinstance(node, ast.Name):
        return node.id in _STATIC_ANNOTATIONS
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            return _annotation_static(ast.parse(node.value,
                                                mode="eval").body)
        except SyntaxError:
            return False
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        sides = [node.left, node.right]
        rest = [s for s in sides
                if not (isinstance(s, ast.Constant) and s.value is None)]
        return bool(rest) and all(_annotation_static(s) for s in rest)
    if isinstance(node, ast.Subscript):
        head = node.value
        name = head.attr if isinstance(head, ast.Attribute) else (
            head.id if isinstance(head, ast.Name) else None)
        if name == "Optional":
            return _annotation_static(node.slice)
    return False


def _call_name(node: ast.Call) -> str | None:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _is_cpu(node: ast.expr) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.split(":")[0] == "cpu")


class _FunctionChecker:
    def __init__(self, rel: str, qualname: str,
                 module_static: set[str]):
        self.rel = rel
        self.qualname = qualname
        self.static: set[str] = set(module_static)
        self.traced: set[str] = set()
        self.masks: set[str] = set()
        self.findings: list[Finding] = []

    # -- static-value inference -------------------------------------------

    def bind_params(self, fn: ast.FunctionDef) -> None:
        args = list(fn.args.posonlyargs) + list(fn.args.args) \
            + list(fn.args.kwonlyargs)
        for a in args:
            if _annotation_static(a.annotation):
                self.static.add(a.arg)
            else:
                self.traced.add(a.arg)
        if fn.args.vararg:
            self.traced.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            self.traced.add(fn.args.kwarg.arg)

    def is_static(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            # statics, module constants, imported helpers: all host values
            return node.id not in self.traced
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return True
            return self.is_static(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_static(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_static(node.left) and self.is_static(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_static(node.operand)
        if isinstance(node, ast.BoolOp):
            return all(self.is_static(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # ``x is None`` / ``x is not None`` is host-static: a tensor is
            # never None (the optional-input idiom, e.g. the alive mask)
            if (all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)
                    and all(isinstance(c, ast.Constant) and c.value is None
                            for c in node.comparators)):
                return True
            return self.is_static(node.left) and \
                all(self.is_static(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return all(self.is_static(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return (self.is_static(node.test) and self.is_static(node.body)
                    and self.is_static(node.orelse))
        if isinstance(node, ast.Call):
            fname = _call_name(node)
            if isinstance(node.func, ast.Attribute):
                return (fname in _STATIC_METHODS
                        or fname in _STATIC_ATTR_CALLS)
            if fname in _ALWAYS_STATIC_CALLS:
                return True
            if fname in _STATIC_CALLS or fname in _CAST_CALLS:
                return all(self.is_static(a) for a in node.args)
            return False            # torch/unknown calls may give tensors
        if isinstance(node, ast.Starred):
            return self.is_static(node.value)
        return False

    def is_mask(self, node: ast.expr) -> bool:
        """Whether ``node`` is (syntactically) a boolean tensor."""
        if self.is_static(node):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return True
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Call):
            # ``x.bool()`` is a mask, the builtin ``bool(x)`` a host bool
            return _call_name(node) in _MASK_CALLS and not (
                isinstance(node.func, ast.Name) and node.func.id == "bool")
        return False

    def assign(self, target: ast.expr, static: bool,
               mask: bool = False) -> None:
        if isinstance(target, ast.Name):
            (self.static if static else self.traced).add(target.id)
            (self.traced if static else self.static).discard(target.id)
            (self.masks.add if mask else self.masks.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self.assign(el, static)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, static)

    def assign_loop(self, target: ast.expr, it: ast.expr) -> None:
        """Bind a ``for`` target: ``enumerate``'s index is a host int."""
        if (isinstance(it, ast.Call) and _call_name(it) == "enumerate"
                and it.args and isinstance(target, ast.Tuple)
                and len(target.elts) == 2):
            self.assign(target.elts[0], True)
            self.assign(target.elts[1], self.is_static(it.args[0]))
            return
        self.assign(target, self.is_static(it))

    # -- the walk ----------------------------------------------------------

    def report(self, line: int, tag: str, msg: str) -> None:
        self.findings.append(Finding(CHECK, self.rel, line,
                                     f"{self.qualname}.{tag}", msg))

    def check_test(self, test: ast.expr, construct: str) -> None:
        if not self.is_static(test):
            src = ast.unparse(test)
            self.report(test.lineno, construct,
                        f"Python {construct} on a traced value "
                        f"({src!r}) in {self.qualname} — a tensor's truth "
                        f"value is a host sync; branch on host values "
                        f"(shapes, modes, devices, None-ness)")

    def walk(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self.walk_stmt(stmt)

    def walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                  # nested defs are checked as own scopes
        if isinstance(stmt, ast.Assign):
            static = self.is_static(stmt.value)
            mask = self.is_mask(stmt.value)
            self.visit_expr(stmt.value)
            for t in stmt.targets:
                self.visit_target(t)
                self.assign(t, static, mask)
            return
        if isinstance(stmt, ast.AugAssign):
            self.visit_expr(stmt.value)
            self.visit_target(stmt.target)
            if isinstance(stmt.target, ast.Name):
                static = stmt.target.id in self.static \
                    and self.is_static(stmt.value)
                self.assign(stmt.target, static)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                # a local declared a host scalar is one, like a parameter
                static = (_annotation_static(stmt.annotation)
                          or self.is_static(stmt.value))
                self.visit_expr(stmt.value)
                self.assign(stmt.target, static)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            kind = "if" if isinstance(stmt, ast.If) else "while"
            self.check_test(stmt.test, kind)
            self.visit_expr(stmt.test)
            self.walk(stmt.body)
            self.walk(stmt.orelse)
            return
        if isinstance(stmt, ast.Assert):
            self.check_test(stmt.test, "assert")
            self.visit_expr(stmt.test)
            return
        if isinstance(stmt, ast.For):
            self.visit_expr(stmt.iter)
            self.assign_loop(stmt.target, stmt.iter)
            self.walk(stmt.body)
            self.walk(stmt.orelse)
            return
        for _f, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                self.visit_expr(value)
            elif isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    self.walk(value)
                else:
                    for v in value:
                        if isinstance(v, ast.expr):
                            self.visit_expr(v)
                        elif isinstance(v, ast.excepthandler):
                            self.walk(v.body)
                        elif isinstance(v, ast.withitem):
                            self.visit_expr(v.context_expr)

    def visit_target(self, target: ast.expr) -> None:
        """A store through ``x[mask]`` syncs like a load through it."""
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            self.visit_expr(target)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self.visit_target(el)

    def visit_expr(self, expr: ast.expr) -> None:
        # bind comprehension targets first: the element is walked before
        # the generator that binds its names
        for node in ast.walk(expr):
            if isinstance(node, ast.comprehension):
                self.assign_loop(node.target, node.iter)
        for node in ast.walk(expr):
            if isinstance(node, ast.comprehension):
                for cond in node.ifs:
                    self.check_test(cond, "comprehension-if")
            elif isinstance(node, ast.IfExp):
                self.check_test(node.test, "ternary")
            elif isinstance(node, ast.Call):
                self.check_call(node)
            elif isinstance(node, ast.Subscript) and self.is_mask(
                    node.slice):
                src = ast.unparse(node)
                self.report(node.lineno, "bool-index",
                            f"indexing with a boolean tensor ({src!r}) in "
                            f"{self.qualname}: the result's size depends on "
                            f"the data, so the host waits for the card")

    def check_call(self, node: ast.Call) -> None:
        func = node.func
        name = _call_name(node)
        if name in _SYNC_METHODS and (isinstance(func, ast.Attribute)
                                      or name == "synchronize"):
            self.report(node.lineno, name,
                        f".{name}() in {self.qualname} is a host sync — it "
                        f"waits for the card")
        elif isinstance(func, ast.Attribute) and name == "to" and (
                any(_is_cpu(a) for a in node.args[:1])
                or any(kw.arg == "device" and _is_cpu(kw.value)
                       for kw in node.keywords)):
            self.report(node.lineno, "to-cpu",
                        f".to('cpu') in {self.qualname} copies to the host "
                        f"— a host sync")
        elif name in _DATA_SIZED:
            self.report(node.lineno, name,
                        f"{name}() in {self.qualname}: its output size "
                        f"depends on the data, so the host waits for the "
                        f"card")
        elif isinstance(func, ast.Name) and name in _CAST_CALLS \
                and node.args and not self.is_static(node.args[0]):
            src = ast.unparse(node.args[0])
            self.report(node.lineno, name,
                        f"{name}() applied to traced value ({src!r}) in "
                        f"{self.qualname} forces a host sync")


def _module_static_names(tree: ast.Module) -> set[str]:
    """Module-level constant names (ACC_BYTES & co) are static."""
    out = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _scan_imports(tree: ast.Module, rel: str, *, check: str,
                  forbidden: set[str], roots: set[str],
                  context: str) -> list[Finding]:
    """Flag imports of nondeterminism sources (clock / ambient RNG)."""
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in forbidden or a.name.split(".")[0] in roots:
                    findings.append(Finding(
                        check, rel, node.lineno, f"import.{a.name}",
                        f"import of '{a.name}' in a {context}"))
        elif isinstance(node, ast.ImportFrom) and node.module:
            root = node.module.split(".")[0]
            if node.module in forbidden or root in roots:
                findings.append(Finding(
                    check, rel, node.lineno, f"import.{node.module}",
                    f"import from '{node.module}' in a {context}"))
    return findings


def check_schedule_module(source: str, rel: str) -> list[Finding]:
    """Determinism lint for workload-schedule generators (serve/workload):
    the schedule must be a pure function of its seed, so the module may not
    import any clock or ambient-RNG source (``time`` / ``random`` /
    ``datetime`` / ``numpy.random`` — seeded ``np.random.default_rng`` via
    the ``numpy`` namespace is the sanctioned idiom).  Import-surface only:
    the kernel lint's per-function traced-value inference would
    false-positive all over ordinary host code, and banning the imports is
    what actually guards against `time`-based nondeterminism."""
    tree = ast.parse(source)
    return _scan_imports(
        tree, rel, check=SCHEDULE_CHECK,
        forbidden=set(_FORBIDDEN_MODULES) | {"datetime"},
        roots={"time", "random", "datetime"},
        context="schedule-generator module — workload schedules must be "
                "pure functions of their seed (no clock, no ambient RNG)")


def check_module(source: str, rel: str, *, syncs: bool = True
                 ) -> list[Finding]:
    """Lint one flavour module; ``syncs=False`` keeps the determinism rules
    only (the plain versions)."""
    tree = ast.parse(source)
    findings = _scan_imports(
        tree, rel, check=CHECK, forbidden=set(_FORBIDDEN_MODULES),
        roots={"time", "random"},
        context="kernel module — kernel flavours must be deterministic "
                "and clock-free")
    if not syncs:
        return findings
    module_static = _module_static_names(tree)

    seen: set[int] = set()

    def check_fn(fn: ast.FunctionDef, prefix: str) -> None:
        if id(fn) in seen:
            return
        seen.add(id(fn))
        qual = f"{prefix}{fn.name}"
        chk = _FunctionChecker(rel, qual, module_static)
        chk.bind_params(fn)
        chk.walk(fn.body)
        findings.extend(chk.findings)
        for node in ast.walk(fn):
            if isinstance(node, ast.FunctionDef) and node is not fn:
                check_fn(node, f"{qual}.")

    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            check_fn(node, "")
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    check_fn(sub, f"{node.name}.")
    return findings


def run(files: list[tuple[str, str]]) -> list[Finding]:
    """files: (absolute path, repo-relative path) pairs; a ``ref.py`` is
    held to the determinism rules only, every other module to all."""
    findings = []
    for path, rel in files:
        with open(path, encoding="utf-8") as fh:
            findings.extend(check_module(
                fh.read(), rel,
                syncs=os.path.basename(path) not in _DETERMINISM_ONLY))
    return findings


__all__ = ["run", "check_module", "check_schedule_module", "CHECK",
           "SCHEDULE_CHECK"]
