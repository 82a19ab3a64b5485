"""What the harness may import: never JAX or the JAX package (top-level
names compared whole: the port's own name begins with the JAX package's),
and, for the plain references, nothing of the program either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "out" not in p.parts)


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch"})


def test_the_whole_name_is_compared():
    src = BENCH / "clients" / "query_batches.py"
    assert "repro_torch" in imported(src)      # the port: allowed


def test_nothing_reads_the_jax_benchmarks_folder():
    for path in SOURCES:
        if path == Path(__file__).resolve():
            continue
        tree = ast.parse(path.read_text())
        assert "benchmarks" not in imported(path), path
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                assert "benchmarks/" not in node.value, path
