"""Nothing under ``bench/`` imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    got = top_level_imports(path)
    assert not got & {"repro_torch", "jax", "jaxlib", "flax", "repro"}
    assert got <= {"__future__", "numpy", "torch"}


def test_the_port_is_not_mistaken_for_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.engine\nfrom repro_torch import x\n")
    assert top_level_imports(f) == {"repro_torch"}
    f.write_text("from repro.engine import Engine\n")
    assert top_level_imports(f) == {"repro"}
