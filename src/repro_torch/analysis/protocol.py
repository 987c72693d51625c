"""Protocol conformance: the cursor protocol and the kernel-package layout.

Cursor protocol (see ``core/query.py``): every class exposing BOTH ``next``
and ``seek_geq`` is a cursor and must provide

* ``next(self)`` — no further parameters;
* ``seek_geq(self, target)`` — exactly one parameter;
* ``docid`` and ``exhausted`` — as methods/properties or fields assigned
  in ``__init__``;
* positional cursors (word-level: class name contains ``Word``) must also
  provide ``positions``, and any ``positions`` must be ``positions(self)``.

The runtime half of the contract (docid monotonicity, the ``seek_geq``
postcondition ``exhausted or docid >= target``) is asserted by
:class:`repro_torch.analysis.contracts.ContractCursor`, which the
differential tests wrap around every implementation.

Kernel packages (``src/repro_torch/kernels/<name>/``): the kernel names are
the keys of ``kernels/build.py``'s ``SOURCES`` (read from the source: a
comprehension over a tuple of names); the registry's
``_OPS_MODULES`` derives from it and must name the same kernels.  A package
directory that ``SOURCES`` does not name, and a name in ``SOURCES`` without
a package, are reported.  Each package must ship ``ref.py`` /
``kernel.py`` / ``ops.py`` and the CUDA source ``SOURCES`` names for it
(``csrc/<name>.cu``), and keep the ref↔kernel entry points
call-compatible — the kernel's positional parameters must extend the
reference's (same names, same order; extras defaulted) and accept every
reference keyword, so the two flavours stay interchangeable behind one ops
dispatcher.  Pairing: ``<stem>_ref`` ↔ ``<stem>_kernel`` by name, else the
unique public function of each module, else the reference function that
``ops.py`` imports.  Signatures are compared with :mod:`inspect` (the ref
may legitimately be a re-export).
"""

from __future__ import annotations

import ast
import importlib
import inspect
import os

from .report import Finding

CHECK = "protocol"


# --------------------------------------------------------------------------
# cursor conformance
# --------------------------------------------------------------------------


def _class_member_names(cls: ast.ClassDef) -> set[str]:
    names = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            if node.name == "__init__":
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Attribute)
                            and isinstance(sub.ctx, ast.Store)
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id == "self"):
                        names.add(sub.attr)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    # __slots__ entries count as members
    for node in cls.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__slots__":
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        for el in node.value.elts:
                            if isinstance(el, ast.Constant):
                                names.add(str(el.value))
    return names


def _method(cls: ast.ClassDef, name: str) -> ast.FunctionDef | None:
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _n_params(fn: ast.FunctionDef) -> int:
    a = fn.args
    return len(a.posonlyargs) + len(a.args)


def check_cursors(files: list[tuple[str, str]]) -> list[Finding]:
    findings = []
    for path, rel in files:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for cls in [n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)]:
            nxt, seek = _method(cls, "next"), _method(cls, "seek_geq")
            if nxt is None or seek is None:
                continue
            members = _class_member_names(cls)

            def report(line, part, msg):
                findings.append(Finding(CHECK, rel, line,
                                        f"{cls.name}.{part}", msg))

            if _n_params(nxt) != 1 or nxt.args.vararg or nxt.args.kwonlyargs:
                report(nxt.lineno, "next",
                       f"cursor {cls.name}.next must take no parameters "
                       f"beyond self")
            if _n_params(seek) != 2 or seek.args.vararg:
                report(seek.lineno, "seek_geq",
                       f"cursor {cls.name}.seek_geq must take exactly one "
                       f"parameter (target) beyond self")
            for required in ("docid", "exhausted"):
                if required not in members:
                    report(cls.lineno, required,
                           f"cursor {cls.name} exposes next/seek_geq but "
                           f"has no '{required}'")
            pos = _method(cls, "positions")
            if "Word" in cls.name and pos is None \
                    and "positions" not in members:
                report(cls.lineno, "positions",
                       f"positional cursor {cls.name} (word-level) must "
                       f"implement positions()")
            if pos is not None and (_n_params(pos) != 1 or pos.args.vararg):
                report(pos.lineno, "positions",
                       f"{cls.name}.positions must take no parameters "
                       f"beyond self")
    return findings




# --------------------------------------------------------------------------
# kernel-package conformance
# --------------------------------------------------------------------------


def _path_parts(expr: ast.expr, env: dict[str, str]) -> list[str] | None:
    """The parts below the kernels directory of a ``KERNELS_DIR / name /
    "csrc" / f"{name}.cu"`` path expression (None: not understood)."""
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Div):
        left = _path_parts(expr.left, env)
        right = _path_parts(expr.right, env)
        return None if left is None or right is None else left + right
    if isinstance(expr, ast.Name):
        if expr.id == "KERNELS_DIR":
            return []
        return [env[expr.id]] if expr.id in env else None
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [expr.value]
    if isinstance(expr, ast.JoinedStr):
        out = []
        for v in expr.values:
            if isinstance(v, ast.Constant):
                out.append(str(v.value))
            elif (isinstance(v, ast.FormattedValue)
                  and isinstance(v.value, ast.Name) and v.value.id in env):
                out.append(env[v.value.id])
            else:
                return None
        return ["".join(out)]
    return None


def _assigned(tree: ast.Module, name: str) -> ast.expr | None:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return node.value
        if (isinstance(node, ast.AnnAssign) and node.value is not None
                and isinstance(node.target, ast.Name)
                and node.target.id == name):
            return node.value
    return None


def _named_sources(build_path: str) -> dict[str, str | None]:
    """``SOURCES`` of ``kernels/build.py``: kernel name -> its CUDA source
    relative to the kernels directory (None where the path expression is
    not understood).  Reads the comprehension over a tuple of names that
    ``build.py`` writes; any other form names no kernel, so every package
    is reported."""
    with open(build_path, encoding="utf-8") as fh:
        value = _assigned(ast.parse(fh.read()), "SOURCES")
    out: dict[str, str | None] = {}
    if (isinstance(value, ast.DictComp) and len(value.generators) == 1
            and isinstance(value.generators[0].target, ast.Name)
            and isinstance(value.generators[0].iter, (ast.Tuple, ast.List))):
        var = value.generators[0].target.id
        for el in value.generators[0].iter.elts:
            if not (isinstance(el, ast.Constant)
                    and isinstance(el.value, str)):
                continue
            env = {var: el.value}
            key = _path_parts(value.key, env)
            parts = _path_parts(value.value, env)
            if key is not None:
                out["/".join(key)] = (None if parts is None
                                      else "/".join(parts))
    return out


def _registered_kernels(registry_path: str, sources) -> set[str]:
    """Keys of the registry's ``_OPS_MODULES``: a dict literal's, or those
    of ``SOURCES`` where it is a comprehension over ``SOURCES``."""
    with open(registry_path, encoding="utf-8") as fh:
        value = _assigned(ast.parse(fh.read()), "_OPS_MODULES")
    if isinstance(value, ast.Dict):
        return {k.value for k in value.keys if isinstance(k, ast.Constant)}
    if (isinstance(value, ast.DictComp)
            and isinstance(value.generators[0].iter, ast.Name)
            and value.generators[0].iter.id == "SOURCES"):
        return set(sources)
    return set()


def _public_functions(mod) -> dict[str, object]:
    out = {}
    for name in dir(mod):
        if name.startswith("_"):
            continue
        fn = getattr(mod, name)
        if inspect.isfunction(fn):
            out[name] = fn
    return out


def _ops_ref_imports(ops_path: str) -> list[str]:
    with open(ops_path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "ref":
            out.extend(a.name for a in node.names)
    return out


def _pair_flavors(name: str, pkg_dir: str, ref_mod, kern_mod
                  ) -> list[tuple[object, object]]:
    refs = _public_functions(ref_mod)
    kerns = {n: f for n, f in _public_functions(kern_mod).items()
             if n.endswith("_kernel")}
    pairs, used_refs = [], set()
    for kname, kfn in sorted(kerns.items()):
        stem = kname[: -len("_kernel")]
        if f"{stem}_ref" in refs:
            pairs.append((refs[f"{stem}_ref"], kfn))
            used_refs.add(f"{stem}_ref")
    unpaired_k = [kfn for kname, kfn in sorted(kerns.items())
                  if not any(p[1] is kfn for p in pairs)]
    ref_suffixed = [n for n in refs if n.endswith("_ref")
                    and n not in used_refs]
    if len(unpaired_k) == 1:
        if len(ref_suffixed) == 1:
            pairs.append((refs[ref_suffixed[0]], unpaired_k[0]))
        else:
            # fall back to the reference entry point ops.py dispatches to
            imported = [n for n in _ops_ref_imports(
                os.path.join(pkg_dir, "ops.py"))
                if n in refs]
            if len(imported) == 1:
                pairs.append((refs[imported[0]], unpaired_k[0]))
    return pairs


def _signature_findings(name: str, rel: str, ref_fn, kern_fn
                        ) -> list[Finding]:
    findings = []
    rsig = inspect.signature(ref_fn)
    ksig = inspect.signature(kern_fn)
    P = inspect.Parameter
    rpos = [p for p in rsig.parameters.values()
            if p.kind in (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)]
    kpos = [p for p in ksig.parameters.values()
            if p.kind in (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)]
    sym = f"{name}.{ref_fn.__name__}~{kern_fn.__name__}"
    line = kern_fn.__code__.co_firstlineno

    def bad(msg):
        findings.append(Finding(CHECK, rel, line, sym, msg))

    if [p.name for p in kpos[:len(rpos)]] != [p.name for p in rpos]:
        bad(f"kernel {kern_fn.__name__}{ksig} positional parameters do not "
            f"extend ref {ref_fn.__name__}{rsig} (same names, same order)")
        return findings
    for extra in kpos[len(rpos):]:
        if extra.default is P.empty:
            bad(f"kernel-only parameter '{extra.name}' of "
                f"{kern_fn.__name__} must have a default (callers pass "
                f"ref-shaped arguments)")
    kaccept = {p.name for p in ksig.parameters.values()
               if p.kind in (P.POSITIONAL_OR_KEYWORD, P.KEYWORD_ONLY)}
    for p in rsig.parameters.values():
        if p.kind == P.KEYWORD_ONLY and p.name not in kaccept:
            bad(f"ref keyword '{p.name}' not accepted by "
                f"{kern_fn.__name__} — flavours are not interchangeable")
    return findings


def _package_of(kernels_dir: str, repo_root: str) -> str:
    """Dotted name of the kernels package (``src/a/kernels`` ->
    ``a.kernels``)."""
    rel = os.path.relpath(kernels_dir, os.path.join(repo_root, "src"))
    return rel.replace(os.sep, ".")


def check_kernels(kernels_dir: str, repo_root: str,
                  package: str | None = None) -> list[Finding]:
    """Layout, ``SOURCES``/registry and ref↔kernel signature conformance of
    every package under ``kernels_dir``; the flavours are imported as
    ``<package>.<name>.ref`` / ``.kernel`` (``package`` defaults to the
    directory's dotted name below ``<repo_root>/src``)."""
    package = package or _package_of(kernels_dir, repo_root)
    findings = []
    build_path = os.path.join(kernels_dir, "build.py")
    build_rel = os.path.relpath(build_path, repo_root)
    sources = _named_sources(build_path)
    registry_path = os.path.join(kernels_dir, "registry.py")
    reg_rel = os.path.relpath(registry_path, repo_root)
    registered = _registered_kernels(registry_path, sources)
    for name in sorted(set(sources) ^ registered):
        findings.append(Finding(
            CHECK, reg_rel, 1, f"{name}.registry",
            f"_OPS_MODULES and build.py's SOURCES disagree on '{name}' — "
            f"a kernel must be built and reachable through the registry "
            f"alike"))
    packages = sorted(
        d for d in os.listdir(kernels_dir)
        if os.path.isdir(os.path.join(kernels_dir, d))
        and os.path.exists(os.path.join(kernels_dir, d, "__init__.py"))
        and not d.startswith("_"))
    for name in packages:
        pkg = os.path.join(kernels_dir, name)
        rel = os.path.relpath(pkg, repo_root)
        missing = [m for m in ("ref.py", "kernel.py", "ops.py")
                   if not os.path.exists(os.path.join(pkg, m))]
        if missing:
            findings.append(Finding(
                CHECK, rel, 1, f"{name}.layout",
                f"kernel package '{name}' is missing {', '.join(missing)} "
                f"(every kernel ships ref/kernel/ops)"))
            continue
        if name not in sources:
            findings.append(Finding(
                CHECK, build_rel, 1, f"{name}.sources",
                f"kernel package '{name}' is not named in SOURCES — its "
                f"CUDA source is never built and the registry cannot "
                f"reach it"))
        elif sources[name] is None:
            findings.append(Finding(
                CHECK, build_rel, 1, f"{name}.sources",
                f"SOURCES names '{name}' with a path this check cannot "
                f"read (write it as KERNELS_DIR / name / 'csrc' / ...)"))
        elif not os.path.isfile(os.path.join(kernels_dir, sources[name])):
            findings.append(Finding(
                CHECK, rel, 1, f"{name}.csrc",
                f"kernel package '{name}' is missing "
                f"{os.path.relpath(sources[name], name)}, the CUDA source "
                f"that SOURCES names for it"))
        ref_mod = importlib.import_module(f"{package}.{name}.ref")
        kern_mod = importlib.import_module(f"{package}.{name}.kernel")
        pairs = _pair_flavors(name, pkg, ref_mod, kern_mod)
        if not pairs:
            findings.append(Finding(
                CHECK, os.path.join(rel, "kernel.py"), 1, f"{name}.pairing",
                f"could not pair a public *_kernel entry point of '{name}' "
                f"with its reference flavour"))
        for ref_fn, kern_fn in pairs:
            findings.extend(_signature_findings(
                name, os.path.join(rel, "kernel.py"), ref_fn, kern_fn))
    for name in sorted(sources):
        if name not in packages:
            where = os.path.relpath(os.path.join(kernels_dir, name),
                                    repo_root)
            findings.append(Finding(
                CHECK, build_rel, 1, f"{name}.sources",
                f"SOURCES names '{name}' but {where}/ does not exist"))
    return findings


__all__ = ["check_cursors", "check_kernels", "CHECK"]
