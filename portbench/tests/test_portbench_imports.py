"""Nothing under portbench/ imports JAX, the JAX package or the old
benchmarks; the reference imports nothing of the program; only the entry
modules portbench/entries/*.py (and the tests, which plant faults) import
the program. Names are compared whole, by their top level: ``dla_tpu_torch``
begins with ``dla_tpu`` and is not it."""

import ast
from pathlib import Path

import pytest

from portbench import spec

FOREIGN = {"jax", "jaxlib", "flax", "dla_tpu", "benchmarks"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                tops.add(arg.value.split(".")[0])
    return tops


FILES = sorted(spec.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FOREIGN


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = _imports(path)
    assert "dla_tpu_torch" not in tops and not tops & FOREIGN
    src = path.read_text()
    for module in ("program", "entries"):
        assert f"portbench.{module}" not in src and f"from portbench import {module}" not in src


def test_only_the_entry_modules_reach_the_program():
    users = {p.relative_to(spec.HERE).as_posix() for p in FILES
             if "dla_tpu_torch" in _imports(p) and "tests" not in p.parts}
    assert users and all(u.startswith("entries/") for u in users)
    assert "program.py" not in users


def test_the_check_compares_names_whole():
    assert "dla_tpu_torch" not in FOREIGN
    assert "dla_tpu_torch".split(".")[0] != "dla_tpu"
    from portbench import machine
    assert "dla_tpu_torch" not in machine.FOREIGN
