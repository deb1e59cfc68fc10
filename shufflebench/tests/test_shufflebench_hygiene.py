"""What the benchmark imports: no module under ``shufflebench/``
imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``sparkrdma_tpu``, and the reference imports nothing of the program
``sparkrdma_tpu_torch``. Top-level names are compared whole: the
port's name begins with the JAX package's."""

import ast

import pytest

from shufflebench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "sparkrdma_tpu"}
MODULES = sorted(p for p in cells.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def test_walk_finds_every_part():
    parts = {p.relative_to(cells.HERE).parts[0] for p in MODULES}
    assert {"entries", "generators", "metrics", "reference", "tests", "run.py",
            "trace.py"} <= parts


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(cells.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in MODULES if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "sparkrdma_tpu_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch"}


def test_whole_names_are_compared():
    path = cells.HERE / "entries" / "terasort_step.py"
    names = top_level_imports(path)
    assert "sparkrdma_tpu_torch" in names and not names & FORBIDDEN
