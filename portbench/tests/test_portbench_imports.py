"""Nothing under portbench/ imports JAX or the JAX package, compared by
whole top-level names (``repro_torch`` begins with ``repro``), and the
reference, the frozen trainer under it and the exit trees' recipe
(``policy.py``) import nothing of the program."""
import ast

import pytest

from conftest import REPO

JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}
BENCH = REPO / "portbench"


def top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not set(top_level_imports(path)) & JAX_SIDE


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.parts],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert set(top_level_imports(path)) <= {"__future__", "dataclasses",
                                            "contextlib", "typing",
                                            "numpy", "torch"}


@pytest.mark.parametrize("name", ["policy.py", "reference/ivf_cascade.py",
                                  "reference/gbdt.py", "reference/smote.py"])
def test_trees_and_cascade_reference_import_no_program(name):
    path = BENCH / name
    assert path in FILES
    assert not set(top_level_imports(path)) & {"repro_torch", "repro"}


def test_whole_names_are_compared():
    assert "repro_torch" not in JAX_SIDE
    assert "repro" in JAX_SIDE
