"""The port's invariant tooling (``repro_torch.analysis``), mirroring
``tests/test_analysis.py`` on the port's modules and holding the copied
passes against the reference's.

Each static check is exercised against a seeded fixture module carrying a
known violation (asserted by file:line); the allowlist semantics are pinned;
the purity lint is driven through every host-sync kind in eager torch, in a
launch wrapper (``kernel.py``) and a dispatcher (``ops.py``), and the same
code in a plain version (``ref.py``) must pass; the kernel-package check is
driven through a copy of the port's ``kernels/`` with one fault seeded at a
time; the lock lint, the cursor pass and the annotation parser must agree
with the reference's on the same sources; the runtime sanitizer is driven
through seeded lock-order inversions and races (and their negatives), the
kernel loader's first load from eight threads, and the port's fleet under
ingest, background freezes and queries; and the port itself must come out
clean end to end.
"""

import contextlib
import dataclasses
import importlib
import shutil
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.analysis import annotations as jax_annotations
from repro.analysis import locks as jax_locks
from repro.analysis import protocol as jax_protocol
from repro_torch.analysis import annotations, locks, protocol, purity
from repro_torch.analysis.contracts import (ContractCursor, ContractViolation,
                                            wrap)
from repro_torch.analysis.report import Allowlist, apply_allowlist
from repro_torch.analysis.sanitizer import Sanitizer

from test_torch_fused_query import assert_ranking

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_CONCURRENT = [
    "src/repro_torch/core/lifecycle.py",
    "src/repro_torch/engine/engine.py",
    "src/repro_torch/engine/device_backend.py",
    "src/repro_torch/serve/query_service.py",
    "src/repro_torch/serve/ingest_pipeline.py",
    "src/repro_torch/core/sharded_index.py",
]
REF_CONCURRENT = [p.replace("repro_torch", "repro") for p in PORT_CONCURRENT]
WAIT_S = 60


def _write(tmp_path, name, source):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source).lstrip("\n"), encoding="utf-8")
    return str(p)


def _key(findings):
    return [(f.check, f.line, f.symbol) for f in findings]


# --------------------------------------------------------------------------
# lock-discipline lint
# --------------------------------------------------------------------------

GUARDED_FIXTURE = """
    import threading


    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0              # guarded_by: _lock
            self.m = 0              # guarded_by: _lock

        def good(self):
            with self._lock:
                self.n += 1

        def bad_write(self):
            self.n += 1

        def bad_read(self):
            return self.m
"""


def test_lock_lint_guarded_field_violation(tmp_path):
    path = _write(tmp_path, "guarded_fixture.py", GUARDED_FIXTURE)
    findings = locks.run([(path, "guarded_fixture.py")])
    assert findings, "seeded guarded-field violation not detected"
    # the unlocked accesses are reported with file:line...
    assert {(f.path, f.line) for f in findings} \
        == {("guarded_fixture.py", 15), ("guarded_fixture.py", 18)}
    assert any(f.symbol == "Counter.bad_write.n" for f in findings)
    assert any(f.symbol == "Counter.bad_read.m" for f in findings)
    # ...and the with-lock access in good() is NOT
    assert not any("good" in f.symbol for f in findings)


PUBLISHED_FIXTURE = """
    import threading


    class Manager:
        def __init__(self):
            self._lock = threading.Lock()
            self.tier = None        # published
            self.epoch = 0          # published

        def _swap(self):            # requires: _lock
            self.tier = object()

        def swap_unlocked(self):
            self._swap()

        def torn(self):
            if self.tier is None:
                return 0
            return self.tier

        def publish_two(self, t, e):
            self.tier = t
            self.epoch = e

        def start(self):
            def work():
                self.epoch += 1
            threading.Thread(target=work).start()
"""


def test_lock_lint_published_protocol_and_requires(tmp_path):
    path = _write(tmp_path, "published_fixture.py", PUBLISHED_FIXTURE)
    findings = locks.run([(path, "published_fixture.py")])
    msgs = {f.symbol: f for f in findings}
    # requires-annotated method called without the lock
    assert "Manager.swap_unlocked._swap()" in msgs
    assert msgs["Manager.swap_unlocked._swap()"].line == 14
    # two loads of a published field in one function = torn read
    assert "Manager.torn.tier" in msgs
    # two published fields stored by one function = non-atomic publication
    assert "Manager.publish_two.epoch+tier" in msgs
    # read-modify-write of a published field from a thread target
    assert "Manager.start.work.epoch" in msgs


WRITER_ONLY_FIXTURE = """
    import threading
    from concurrent.futures import ThreadPoolExecutor


    class Resident:
        def __init__(self):
            self._frozen = None     # writer_only
            self.shared = {}        # gil_shared
            self.count = 0
            self._pool = ThreadPoolExecutor(2)

        def refresh(self):
            self._frozen = object()

        def fan_out(self, xs):
            return list(self._pool.map(lambda x: self._frozen, xs))

        def rebind(self):
            self.shared = {}

        def start(self):
            def work():
                self.count = 1
            threading.Thread(target=work).start()
            self.count = 2
"""


def test_lock_lint_writer_only_gil_shared_and_unannotated(tmp_path):
    path = _write(tmp_path, "writer_fixture.py", WRITER_ONLY_FIXTURE)
    by_symbol = {f.symbol: f for f in locks.run([(path, "w.py")])}
    # a writer_only field read from a thread-pool lambda
    assert by_symbol["Resident.fan_out.<lambda>._frozen"].line == 16
    # a gil_shared container rebound outside __init__
    assert by_symbol["Resident.rebind.shared"].line == 19
    # an unannotated field written from the writer and a thread target
    assert "Resident.count" in by_symbol
    assert "Resident.refresh._frozen" not in by_symbol


# --------------------------------------------------------------------------
# the lock lint, the cursor pass and the annotation grammar held against
# the reference's on the same sources
# --------------------------------------------------------------------------


def _seeded_lifecycle(tmp_path):
    """The port's lifecycle with two seeded violations: a guarded field
    read outside its lock and a requires-method called without it."""
    src = (PORT / "core" / "lifecycle.py").read_text(encoding="utf-8")
    anchor = "    # -- observability -----"
    assert src.count(anchor) >= 1
    seeded = src.replace(anchor, (
        "    def peek(self) -> int:\n"
        "        self._grant()\n"
        "        return self._in_flight + self.deferrals\n\n" + anchor), 1)
    p = tmp_path / "seeded_lifecycle.py"
    p.write_text(seeded, encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("which", ["guarded", "published", "writer_only",
                                   "port_modules", "reference_modules",
                                   "seeded_port_module"])
def test_lock_lint_agrees_with_reference(tmp_path, which):
    fixtures = {"guarded": GUARDED_FIXTURE, "published": PUBLISHED_FIXTURE,
                "writer_only": WRITER_ONLY_FIXTURE}
    if which in fixtures:
        files = [(_write(tmp_path, "f.py", fixtures[which]), "f.py")]
    elif which == "port_modules":
        files = [(str(REPO / rel), rel) for rel in PORT_CONCURRENT]
    elif which == "reference_modules":
        files = [(str(REPO / rel), rel) for rel in REF_CONCURRENT]
    else:
        files = [(_seeded_lifecycle(tmp_path), "lifecycle.py")]
    got, want = locks.run(files), jax_locks.run(files)
    assert _key(got) == _key(want)
    assert [f.path for f in got] == [f.path for f in want]
    if which in fixtures or which == "seeded_port_module":
        assert got, "the seeded violations must be found"
    if which == "seeded_port_module":
        syms = {f.symbol for f in got}
        assert "FreezeCoordinator.peek._in_flight" in syms
        assert "FreezeCoordinator.peek._grant()" in syms
    if which == "port_modules":
        assert got == []


@pytest.mark.parametrize("rel", PORT_CONCURRENT)
def test_annotations_parse_agrees_with_reference(rel):
    src = (REPO / rel).read_text(encoding="utf-8")
    got = dataclasses.asdict(annotations.parse(src))
    want = dataclasses.asdict(jax_annotations.parse(src))
    assert got == want
    assert not annotations.parse(src).empty


def test_restored_annotations_are_read():
    """The engine's published ``version`` and the resident manager's four
    writer_only fields are back, so the lint checks them as the
    reference's does."""
    eng = annotations.parse((PORT / "engine" / "engine.py").read_text())
    assert eng.field_kind("Engine", "version") == annotations.PUBLISHED
    dev = annotations.parse(
        (PORT / "engine" / "device_backend.py").read_text())
    for f in ("_frozen", "_delta", "_synced_version", "_nblk_np"):
        assert dev.field_kind("ResidentImageManager", f) \
            == annotations.WRITER_ONLY, f
    ref = jax_annotations.parse(
        (REPO / "src/repro/engine/device_backend.py").read_text())
    ref_wo = {f for c, f in ref.writer_only if c == "ResidentImageManager"}
    assert ref_wo <= {f for c, f in dev.writer_only
                      if c == "ResidentImageManager"}


@pytest.mark.parametrize("which", ["fixture", "port_sources"])
def test_cursor_pass_agrees_with_reference(tmp_path, which):
    if which == "fixture":
        files = [(_write(tmp_path, "c.py", CURSOR_FIXTURE), "c.py")]
    else:
        files = [(str(p), str(p.relative_to(REPO)))
                 for p in sorted(PORT.rglob("*.py"))
                 if "analysis" not in p.parts]
    got = protocol.check_cursors(files)
    assert _key(got) == _key(jax_protocol.check_cursors(files))
    assert bool(got) == (which == "fixture")


# --------------------------------------------------------------------------
# cursor protocol conformance
# --------------------------------------------------------------------------

CURSOR_FIXTURE = """
    class BadCursor:
        def __init__(self):
            self.docid = 0

        def next(self, n):
            return n

        def seek_geq(self):
            return False


    class WordPhantomCursor:
        def __init__(self):
            self.docid = 0
            self.exhausted = False

        def next(self):
            return False

        def seek_geq(self, target):
            return False
"""


def test_cursor_protocol_nonconformance(tmp_path):
    path = _write(tmp_path, "cursor_fixture.py", CURSOR_FIXTURE)
    findings = protocol.check_cursors([(path, "cursor_fixture.py")])
    by_symbol = {f.symbol: f for f in findings}
    assert by_symbol["BadCursor.next"].line == 5        # extra parameter
    assert by_symbol["BadCursor.seek_geq"].line == 8    # missing target
    assert "BadCursor.exhausted" in by_symbol           # missing member
    # word-level cursor without positions()
    assert by_symbol["WordPhantomCursor.positions"].line == 12
    assert all(f.path == "cursor_fixture.py" for f in findings)


# --------------------------------------------------------------------------
# kernel purity lint, in eager torch's terms
# --------------------------------------------------------------------------

PURITY_FIXTURE = """
    import time


    def kern(x, n: int):
        if x.sum() > 0:
            y = x.item()
        z = float(x)
        while n > 1:
            n -= 1
        return x.tolist(), y, z
"""


def test_kernel_purity_host_sync_and_traced_branch(tmp_path):
    path = _write(tmp_path, "kernel.py", PURITY_FIXTURE)
    findings = purity.run([(path, "kernel.py")])
    lines = {(f.symbol, f.line) for f in findings}
    assert ("import.time", 1) in lines          # clocks are forbidden
    assert ("kern.if", 5) in lines              # branch on a tensor's value
    assert ("kern.item", 6) in lines            # host sync
    assert ("kern.float", 7) in lines           # host sync
    assert ("kern.tolist", 10) in lines         # host sync
    # branching on the STATIC (int-annotated) parameter is the idiom: ok
    assert not any(s == "kern.while" for s, _ in lines)


#: each host-sync kind: a function with the sync on the line marked
#: ``# sync``, and the symbol it must be reported under
SYNC_CASES = {
    "item": ("def f(x):\n    return x.sum().item()  # sync\n", "f.item"),
    "tolist": ("def f(x):\n    return x.tolist()  # sync\n", "f.tolist"),
    "cpu": ("def f(x):\n    return x.cpu()  # sync\n", "f.cpu"),
    "numpy": ("def f(x):\n    return x.numpy()  # sync\n", "f.numpy"),
    "to-cpu": ('def f(x):\n    return x.to("cpu")  # sync\n', "f.to-cpu"),
    "to-device-cpu": ('def f(x):\n    return x.to(device="cpu")  # sync\n',
                      "f.to-cpu"),
    "cuda-synchronize": ("import torch\n\n\ndef f(x):\n"
                         "    torch.cuda.synchronize()  # sync\n"
                         "    return x\n", "f.synchronize"),
    "stream-synchronize": ("import torch\n\n\ndef f(x):\n"
                           "    s = torch.cuda.current_stream()\n"
                           "    s.synchronize()  # sync\n"
                           "    return x\n", "f.synchronize"),
    "imported-synchronize": ("from torch.cuda import synchronize\n\n\n"
                             "def f(x):\n    synchronize()  # sync\n"
                             "    return x\n", "f.synchronize"),
    "event-synchronize": ("def f(x, done):\n"
                          "    done.synchronize()  # sync\n"
                          "    return x\n", "f.synchronize"),
    "float": ("def f(x):\n    return float(x.sum())  # sync\n", "f.float"),
    "int": ("def f(x):\n    return int(x[0])  # sync\n", "f.int"),
    "bool": ("def f(x):\n    return bool(x.any())  # sync\n", "f.bool"),
    "torch-nonzero": ("import torch\n\n\ndef f(x):\n"
                      "    return torch.nonzero(x)  # sync\n", "f.nonzero"),
    "method-nonzero": ("def f(x):\n    return x.nonzero()  # sync\n",
                       "f.nonzero"),
    "torch-unique": ("import torch\n\n\ndef f(x):\n"
                     "    return torch.unique(x)  # sync\n", "f.unique"),
    "bool-index": ("def f(x):\n    keep = (x > 0) & (x < 9)\n"
                   "    return x[keep]  # sync\n", "f.bool-index"),
    "bool-index-store": ("def f(x):\n    x[x < 0] = 0  # sync\n"
                         "    return x\n", "f.bool-index"),
    "if": ("def f(x):\n    if x.sum() > 0:  # sync\n        return x\n"
           "    return -x\n", "f.if"),
    "while": ("def f(x):\n    while (x > 0).any():  # sync\n"
              "        x = x - 1\n    return x\n", "f.while"),
    "ternary": ("def f(x):\n    return x if x.max() > 1 else -x  # sync\n",
                "f.ternary"),
    "comprehension-if": ("def f(xs):\n"
                         "    return [t for t in xs if t.sum() > 0]  # sync\n",
                         "f.comprehension-if"),
    "assert": ("def f(x):\n    assert (x >= 0).all()  # sync\n"
               "    return x\n", "f.assert"),
}


@pytest.mark.parametrize("module", ["kernel.py", "ops.py", "ref.py"])
@pytest.mark.parametrize("kind", sorted(SYNC_CASES))
def test_purity_sync_kinds_by_flavour(tmp_path, kind, module):
    """Every sync kind is reported in a launch wrapper and a dispatcher;
    the plain version (``ref.py``) is held to the determinism rules only."""
    source, symbol = SYNC_CASES[kind]
    line = next(i for i, ln in enumerate(source.splitlines(), start=1)
                if ln.endswith("# sync"))
    path = tmp_path / "pkg" / module
    path.parent.mkdir()
    path.write_text(source, encoding="utf-8")
    findings = purity.run([(str(path), f"pkg/{module}")])
    if module == "ref.py":
        assert findings == []
    else:
        assert (symbol, line) in {(f.symbol, f.line) for f in findings}, \
            "\n".join(map(str, findings))
        assert all(f.check == purity.CHECK for f in findings)


@pytest.mark.parametrize("module", ["kernel.py", "ops.py", "ref.py"])
def test_purity_determinism_rules_hold_in_every_flavour(tmp_path, module):
    src = ("import random\nimport time\n"
           "from numpy.random import default_rng\n\n\n"
           "def f(x):\n    return x\n")
    path = _write(tmp_path / "pkg", module, src)
    got = {(f.symbol, f.line) for f in purity.run([(path, module)])}
    assert got == {("import.random", 1), ("import.time", 2),
                   ("import.numpy.random", 3)}


PORT_IDIOMS = """
    import torch

    TILE = 512


    def launch(x, y=None, mode: str = "c", k: int = 10):
        if x.is_cuda and x.dim() == 2 and x.numel() > 0:
            pass
        if not x.is_contiguous() or x.stride(0) != x.shape[1]:
            raise ValueError("layout")
        if x.size(0) % TILE != 0 and x.element_size() == 4:
            pass
        if y is not None and isinstance(y, torch.Tensor) and len(y) > 0:
            pass
        if x.device.type != "cuda" or x.dtype != torch.int32:
            pass
        if x.data_ptr() % 16:
            pass
        for i, t in enumerate((x, y)):
            shape = (1, 2) if i == 0 else (3,)
        cap: int = x.shape[0]
        while cap > 1:
            cap //= 2
        keep = x[: x.numel() // 2]
        out = torch.empty(shape, device=x.device).to(x.device)
        return (k if mode == "c" else cap), keep, out
"""


@pytest.mark.parametrize("module", ["kernel.py", "ops.py"])
def test_purity_passes_port_kernel_idioms(tmp_path, module):
    """Tensor metadata (``is_cuda``, ``numel()``, ``dim()``, ``stride()``,
    ``data_ptr()``, the device and dtype), ``isinstance``, ``len()``,
    None-ness, ``enumerate``'s index and a local declared ``int`` are host
    values: branching on them is the idiom and passes."""
    path = _write(tmp_path / "pkg", module, PORT_IDIOMS)
    assert purity.run([(path, module)]) == []


@pytest.mark.parametrize("annotation,reported", [
    ("float | None", False), ("Optional[float]", False),
    ("'float | None'", False), ("None | int", False), ("float", False),
    (None, True), ("torch.Tensor | None", True)])
def test_purity_float_of_annotated_parameter(tmp_path, annotation,
                                             reported):
    """``float()`` of a parameter annotated as a host number (``X | None``,
    ``Optional[X]``, also as a string) is static; of an unannotated or
    tensor-annotated one it is a sync."""
    sig = "n_stat=None" if annotation is None \
        else f"n_stat: {annotation} = None"
    src = ("from typing import Optional\n\nimport torch\n\n\n"
           f"def prepare(x, *, {sig}):\n"
           "    return torch.tensor(float(4 if n_stat is None "
           "else n_stat))\n")
    path = _write(tmp_path / "pkg", "ops.py", src)
    findings = purity.run([(path, "ops.py")])
    assert bool(findings) == reported, findings
    if reported:
        assert {(f.symbol, f.line) for f in findings} == {
            ("prepare.float", 7)}


def test_purity_schedule_module_lint():
    """The schedule-purity lint passes the port's workload generator and
    flags a clock import."""
    src = (PORT / "serve" / "workload.py").read_text(encoding="utf-8")
    assert purity.check_schedule_module(src, "workload.py") == []
    bad = purity.check_schedule_module("import datetime\nimport time\n",
                                       "w.py")
    assert {f.symbol for f in bad} == {"import.datetime", "import.time"}
    assert all(f.check == purity.SCHEDULE_CHECK for f in bad)


# --------------------------------------------------------------------------
# kernel-package check on a copy of the port's kernels/
# --------------------------------------------------------------------------


_COPIES = iter(range(10**6))


@pytest.fixture
def port_copy(tmp_path, monkeypatch):
    """A copy of ``src/repro_torch`` under a top-level name of its own
    (importable beside the real package): (its kernels/, the repo root of
    the copy, the kernels' dotted package)."""
    name = f"rt_copy_{next(_COPIES)}"
    dst = tmp_path / "src" / name
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    monkeypatch.syspath_prepend(str(tmp_path / "src"))
    importlib.invalidate_caches()
    yield dst / "kernels", tmp_path, f"{name}.kernels"
    for mod in [m for m in sys.modules if m.split(".")[0] == name]:
        del sys.modules[mod]


def _kernel_findings(kernels, root, package):
    return protocol.check_kernels(str(kernels), str(root), package)


def test_kernel_check_clean_on_port_copy(port_copy):
    kernels, root, package = port_copy
    assert _kernel_findings(kernels, root, package) == []
    assert set(protocol._named_sources(str(kernels / "build.py"))) == {
        "fused_query", "intersect", "topk_score", "dvbyte_decode",
        "retrieval_dot"}


def test_kernel_check_missing_cuda_source(port_copy):
    kernels, root, package = port_copy
    (kernels / "intersect" / "csrc" / "intersect.cu").unlink()
    got = {f.symbol: f for f in _kernel_findings(kernels, root, package)}
    assert set(got) == {"intersect.csrc"}
    assert got["intersect.csrc"].path.endswith("kernels/intersect")
    assert "csrc/intersect.cu" in got["intersect.csrc"].message


def test_kernel_check_package_not_in_sources(port_copy):
    kernels, root, package = port_copy
    shutil.copytree(kernels / "topk_score", kernels / "topk_extra")
    got = {f.symbol: f for f in _kernel_findings(kernels, root, package)}
    assert set(got) == {"topk_extra.sources"}
    assert got["topk_extra.sources"].path.endswith("kernels/build.py")


def test_kernel_check_source_name_without_package(port_copy):
    kernels, root, package = port_copy
    build = kernels / "build.py"
    src = build.read_text(encoding="utf-8")
    old = '"retrieval_dot")'
    assert src.count(old) == 1
    build.write_text(src.replace(old, '"retrieval_dot", "bitonic")'),
                     encoding="utf-8")
    got = {f.symbol: f for f in _kernel_findings(kernels, root, package)}
    assert set(got) == {"bitonic.sources"}
    assert "kernels/bitonic/ does not exist" in got["bitonic.sources"].message


def test_kernel_check_registry_disagrees_with_sources(port_copy):
    kernels, root, package = port_copy
    reg = kernels / "registry.py"
    src = reg.read_text(encoding="utf-8")
    old = ('_OPS_MODULES = {name: f"repro_torch.kernels.{name}.ops" '
           'for name in SOURCES}')
    assert src.count(old) == 1
    reg.write_text(src.replace(old, (
        '_OPS_MODULES = {"fused_query": "x", "intersect": "x", '
        '"topk_score": "x", "dvbyte_decode": "x"}')), encoding="utf-8")
    got = {f.symbol for f in _kernel_findings(kernels, root, package)}
    assert got == {"retrieval_dot.registry"}


def test_kernel_check_signature_mismatch(port_copy):
    """A kernel whose positional parameters do not extend its plain
    version's (here ``intersect_kernel(b, a, ...)`` against
    ``intersect_ref(a, b)``) is reported at the kernel's line."""
    kernels, root, package = port_copy
    kern = kernels / "intersect" / "kernel.py"
    src = kern.read_text(encoding="utf-8")
    old = "def intersect_kernel(a: torch.Tensor, b: torch.Tensor,"
    assert src.count(old) == 1
    kern.write_text(src.replace(
        old, "def intersect_kernel(b: torch.Tensor, a: torch.Tensor,"),
        encoding="utf-8")
    got = _kernel_findings(kernels, root, package)
    assert [f.symbol for f in got] == [
        "intersect.intersect_ref~intersect_kernel"]
    line = next(i for i, ln in enumerate(
        kern.read_text().splitlines(), start=1)
        if ln.startswith("def intersect_kernel("))
    assert got[0].line == line
    assert "do not extend" in got[0].message


# --------------------------------------------------------------------------
# allowlist
# --------------------------------------------------------------------------


def test_allowlist_suppresses_exactly_one(tmp_path):
    path = _write(tmp_path, "guarded_fixture.py", GUARDED_FIXTURE)
    findings = locks.run([(path, "guarded_fixture.py")])
    target = next(f for f in findings if f.symbol == "Counter.bad_read.m")
    allow_file = tmp_path / "allow.txt"
    allow_file.write_text(
        f"# reviewed: read is benign in this fixture\n"
        f"{target.ident}\n"
        f"lock-discipline:guarded_fixture.py:Counter.gone.x  # stale\n",
        encoding="utf-8")
    allowlist = Allowlist.load(str(allow_file))
    reported = apply_allowlist(findings, allowlist)
    assert len(reported) == len(findings) - 1
    assert all(f.symbol != "Counter.bad_read.m" for f in reported)
    # idents are line-independent, so the entry survives edits above it
    assert ":18" not in target.ident and "Counter.bad_read.m" in target.ident
    # unmatched entries are stale — they must fail the run, not linger
    assert allowlist.stale() \
        == ["lock-discipline:guarded_fixture.py:Counter.gone.x"]


# --------------------------------------------------------------------------
# the port itself: the acceptance criterion
# --------------------------------------------------------------------------


def test_static_pass_clean_on_port():
    from repro_torch.analysis.__main__ import _repo_root, collect_findings
    assert Path(_repo_root()) == REPO
    findings = collect_findings(_repo_root())
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_exit_zero_on_clean_port(capsys):
    from repro_torch.analysis.__main__ import DEFAULT_ALLOWLIST, main
    assert (REPO / DEFAULT_ALLOWLIST).is_file()
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out
    assert "stale" not in out


def test_cli_fails_on_a_stale_entry_and_on_the_reference_allowlist(
        tmp_path, capsys):
    """Each CLI fails on the other's entries as stale: the port's
    allowlist is its own file."""
    from repro_torch.analysis.__main__ import main
    allow = tmp_path / "allow.txt"
    allow.write_text("kernel-purity:src/repro/kernels/x/kernel.py:f.if\n",
                     encoding="utf-8")
    assert main(["--allowlist", str(allow)]) == 1
    assert "stale allowlist entry" in capsys.readouterr().out


# --------------------------------------------------------------------------
# runtime contract wrapper
# --------------------------------------------------------------------------


class _ListCursor:
    """Minimal well-behaved doc-level cursor over a sorted docid list."""

    def __init__(self, ids):
        self.ids = list(ids)
        self.i = 0

    @property
    def docid(self):
        return self.ids[self.i]

    @property
    def exhausted(self):
        return self.i >= len(self.ids)

    def next(self):
        self.i += 1
        return not self.exhausted

    def seek_geq(self, target):
        while not self.exhausted and self.docid < target:
            self.i += 1
        return not self.exhausted


def test_contract_cursor_passes_well_behaved():
    cur = wrap(_ListCursor([1, 4, 9]), strict=True)
    assert isinstance(cur, ContractCursor)
    assert wrap(cur) is cur                     # idempotent
    assert cur.seek_geq(3) and cur.docid == 4
    assert cur.next() and cur.docid == 9
    assert not cur.seek_geq(10) and cur.exhausted


def test_contract_cursor_catches_violations():
    class LandsShort(_ListCursor):
        def seek_geq(self, target):
            return not self.exhausted           # never advances

    with pytest.raises(ContractViolation, match="seek_geq"):
        wrap(LandsShort([1, 4, 9])).seek_geq(5)

    class GoesBackwards(_ListCursor):
        def next(self):
            self.ids[self.i] -= 2
            return True

    cur = wrap(GoesBackwards([5, 5, 5]))
    with pytest.raises(ContractViolation, match="backwards"):
        cur.next()

    class BadPositions(_ListCursor):
        def positions(self):
            return [3, 3]

    with pytest.raises(ContractViolation, match="increasing"):
        wrap(BadPositions([1])).positions()


# --------------------------------------------------------------------------
# runtime sanitizer: lock-order inversions
# --------------------------------------------------------------------------


def test_sanitizer_detects_seeded_lock_order_inversion():
    """A -> B in one region, B -> A in another: the acquisition graph has a
    cycle, reported deterministically even though nothing deadlocked."""
    san = Sanitizer("inversion")
    a, b = san.lock("A"), san.lock("B")
    with a:
        with b:
            pass
    assert not san.findings                     # one order alone is fine
    with b:
        with a:
            pass
    assert len(san.findings) == 1
    f = san.findings[0]
    assert "lock-order inversion" in f.message
    assert "A" in f.message and "B" in f.message
    # reported once, not per re-occurrence
    with b:
        with a:
            pass
    assert len(san.findings) == 1


def test_sanitizer_inversion_across_threads():
    san = Sanitizer("inversion-mt")
    a, b = san.lock("outer"), san.lock("inner")
    order_ab = threading.Event()

    def t1():
        with a:
            with b:
                order_ab.set()

    def t2():
        order_ab.wait(timeout=10)
        with b:
            with a:
                pass

    ts = [threading.Thread(target=t1), threading.Thread(target=t2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
        assert not t.is_alive()
    assert any("lock-order inversion" in f.message for f in san.findings)


def test_sanitizer_no_false_positive_on_consistent_order():
    san = Sanitizer("consistent")
    a, b = san.lock("A"), san.lock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    with a:
        pass
    with b:
        pass
    assert not san.findings


# --------------------------------------------------------------------------
# runtime sanitizer: lockset race detection
# --------------------------------------------------------------------------


class _Box:
    def __init__(self):
        self.n = 0


def _run_pair(fn):
    start = threading.Barrier(2)
    hold = threading.Barrier(2)     # both threads alive across the window

    def worker():
        start.wait(timeout=10)
        fn()
        hold.wait(timeout=10)

    ts = [threading.Thread(target=worker) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
        assert not t.is_alive()


def test_sanitizer_detects_unlocked_race():
    san = Sanitizer("race")
    box = san.shadow(_Box(), "n")

    def bump():
        for _ in range(5):
            box.n = box.n + 1

    _run_pair(bump)
    races = [f for f in san.findings if f.symbol.startswith("race.")]
    assert races and "_Box.n" in races[0].symbol


def test_sanitizer_clean_with_common_lock():
    san = Sanitizer("locked")
    box = san.shadow(_Box(), "n")
    guard = san.lock("guard")

    def bump():
        for _ in range(5):
            with guard:
                box.n = box.n + 1

    _run_pair(bump)
    assert not san.findings


def test_sanitizer_thread_termination_happens_before():
    """A join() is a synchronization point: the main thread reading what a
    finished worker wrote is NOT a race."""
    san = Sanitizer("join-hb")
    box = san.shadow(_Box(), "n")

    def fill():
        box.n = 42

    t = threading.Thread(target=fill)
    t.start()
    t.join()
    assert box.n == 42
    assert not san.findings


def test_sanitizer_instruments_port_modules_only():
    """After ``enable()``, a lock made by a ``repro_torch`` module is
    instrumented and one made by the standard library is real."""
    from repro_torch.core.lifecycle import FreezeCoordinator
    import queue
    san = Sanitizer("callers")
    san.enable()
    try:
        coord = FreezeCoordinator()
        q = queue.Queue()
    finally:
        san.disable()
    assert type(coord._cond._lock).__name__ == "_SanLock"
    assert type(q.mutex).__name__ != "_SanLock"
    assert not san.findings


# --------------------------------------------------------------------------
# the kernel loader's first load from eight threads (kernels/build.py keeps
# its state in module globals, out of the lock lint's reach)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("locked", [True, False])
def test_kernel_load_under_sanitizer(monkeypatch, locked):
    """Eight threads make the first load of one kernel with build and open
    stubbed.  Under ``_LOAD_LOCK`` (swapped for an instrumented lock): one
    build, no finding.  Without it (the control): several builds, and the
    sanitizer reports the race on the build counter."""
    from repro_torch.kernels import build
    san = Sanitizer(f"kernel-load-{locked}")
    builds = san.shadow(_Box(), "n", label="builds")
    go = threading.Barrier(8)

    def fake_build(names):
        builds.n = builds.n + 1
        threading.Event().wait(0.05)        # widen the race window
        return {n: f"/nonexistent/lib{n}.so" for n in names}

    class FakeLib:
        def __init__(self, path):
            self.path = path

    monkeypatch.setattr(build, "build_all", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "_LOAD_LOCK",
                        san.lock("_LOAD_LOCK") if locked
                        else contextlib.nullcontext())
    got = []

    def first_use():
        go.wait(timeout=WAIT_S)
        got.append(build.load("fused_query"))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(WAIT_S)
        assert not th.is_alive()
    assert len(got) == 8
    if locked:
        assert builds.n == 1 and all(lib is got[0] for lib in got)
        assert not san.findings, san.report()
    else:
        assert builds.n > 1
        assert any(f.symbol == "race.builds.n" for f in san.findings)


# --------------------------------------------------------------------------
# sanitizer-instrumented fleet stress: clean runs + seeded inversion caught
# --------------------------------------------------------------------------


def _stress_docs(n=80):
    rng = np.random.default_rng(99)
    vocab = [f"s{i}" for i in range(60)]
    return vocab, [[vocab[i] for i in rng.choice(60, size=12)]
                   for _ in range(n)]


def test_sanitizer_stress_ingest_freeze_query_clean():
    """ingest + background freeze + fan-out queries under full lock
    instrumentation and with the coordinator's slot accounting shadowed:
    the port's fleet locking must produce zero findings."""
    from repro_torch.core.lifecycle import FreezePolicy
    from repro_torch.core.sharded_index import ShardedEngine
    from repro_torch.engine import Query

    vocab, docs = _stress_docs()
    san = Sanitizer("stress")
    san.enable()
    try:
        se = ShardedEngine(
            num_shards=2, B=64, growth="const", device="cpu",
            tier_policy=FreezePolicy(every_docs=8, background=True),
            max_in_flight=1)
        san.shadow(se.coordinator, "_in_flight", "_waiters",
                   "peak_in_flight", "deferrals", label="FreezeCoordinator")
        for i, d in enumerate(docs):
            se.add_document(d)
            if i % 11 == 5:
                se.execute(Query(terms=(vocab[3], vocab[7]),
                                 mode="conjunctive"))
        se.drain_freezes()
        assert se.coordinator.peak_in_flight >= 1
        se.close()
    finally:
        san.disable()
    assert not san.findings, san.report()


def test_sanitizer_stress_catches_seeded_inversion():
    """The same stress shape, but the test deliberately wraps some ingests
    in (A then B) and others in (B then A) — the sanitizer must catch the
    seeded lock-order inversion."""
    from repro_torch.core.lifecycle import FreezePolicy
    from repro_torch.core.sharded_index import ShardedEngine

    vocab, docs = _stress_docs(40)
    san = Sanitizer("seeded")
    san.enable()
    try:
        se = ShardedEngine(
            num_shards=2, B=64, growth="const", device="cpu",
            tier_policy=FreezePolicy(every_docs=8, background=True),
            max_in_flight=1)
        ingest_mu = threading.Lock()    # instrumented: created by a test
        stats_mu = threading.Lock()     # module while enable() is active
        for i, d in enumerate(docs):
            if i % 2:
                with ingest_mu:
                    with stats_mu:
                        se.add_document(d)
            else:
                with stats_mu:
                    with ingest_mu:     # inverted order: the seeded bug
                        se.add_document(d)
        se.drain_freezes()
        se.close()
    finally:
        san.disable()
    assert any("lock-order inversion" in f.message for f in san.findings), \
        "seeded inversion went undetected"


def test_sanitizer_pipelined_fleet_background_freezes_clean(monkeypatch):
    """The concurrency ``chip_smoke.py``'s sanitized fleet phase runs on
    the card, here on the CPU at a small size: per-shard pipelined writers
    that start background bp128 freezes under one encode slot (the encode
    slowed, so that the second shard is deferred), the fan-out pool
    serving device batches (the plain version) behind
    ``QueryService(pipelined=True)``, every ``guarded_by`` field shadowed.
    No finding; one slot at most, a deferral; every answer equals the
    fleet's host backend."""
    from repro_torch.core import static_index as static_index_mod
    from repro_torch.core.lifecycle import FreezePolicy
    from repro_torch.core.sharded_index import ShardedEngine
    from repro_torch.engine import Query
    from repro_torch.serve import QueryService

    real_freeze = static_index_mod.StaticIndex.freeze

    def slow_freeze(index, codec="bp128"):
        threading.Event().wait(0.2)
        return real_freeze(index, codec)

    monkeypatch.setattr(static_index_mod.StaticIndex, "freeze", slow_freeze)
    vocab, docs = _stress_docs(256)
    san = Sanitizer("pipelined-fleet")
    san.enable()
    try:
        se = ShardedEngine(
            num_shards=2, B=64, growth="const", device="cpu",
            delta_compact_frac=None, max_in_flight=1,
            tier_policy=FreezePolicy(every_docs=32, background=True,
                                     codec="bp128"))
        svc = QueryService(se, max_batch=8, pipelined=True)
        coord = se.coordinator
        san.shadow(coord, "_in_flight", "_waiters", "peak_in_flight",
                   "deferrals", label="FreezeCoordinator")
        for w in svc.pipeline._writers:
            san.shadow(w, "_completed", "_error", label="ShardWriter")
        served = []
        for i in range(0, len(docs), 32):
            svc.ingest_batch(docs[i:i + 32])
            for mode in ("conjunctive", "ranked_tfidf", "bm25"):
                qs = [Query(terms=(vocab[j], vocab[(j * 7 + 1) % 60]),
                            mode=mode, k=5) for j in range(i % 8, i % 8 + 8)]
                tickets = [svc.submit(q) for q in qs]   # 8 fill a batch
                host = [se.execute(Query(terms=q.terms, mode=mode, k=5,
                                         backend="host")) for q in qs]
                served += list(zip(tickets, host))
        svc.pipeline.drain()
        se.drain_freezes()
        with coord._cond:
            peak, deferrals = coord.peak_in_flight, coord.deferrals
        svc.close()
        se.close()
    finally:
        san.disable()
    assert not san.findings, san.report()
    assert peak == 1 and deferrals >= 1
    assert all(e.lifecycle.epoch >= 1 for e in se.engines)
    for t, h in served:
        assert t.result.backend == "device"
        if t.query.mode == "conjunctive":
            assert t.result.docids.tolist() == h.docids.tolist()
        else:
            assert_ranking(np.asarray(t.result.docids),
                           np.asarray(t.result.scores), np.asarray(h.docids),
                           np.asarray(h.scores), 1e-5)
