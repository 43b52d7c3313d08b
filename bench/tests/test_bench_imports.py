"""No module of the benchmark imports JAX, Flax or the JAX package, and
the plain reference imports nothing of the program either.  Names are
compared whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import sys
import types
from pathlib import Path

from bench.harness.main import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not top_level_imports(f) & set(FORBIDDEN), f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        names = top_level_imports(f)
        assert "repro_torch" not in names and not names & set(FORBIDDEN), f
        assert names <= {"__future__", "math", "torch"}, (f, names)


def test_loaded_modules_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert forbidden_modules() == ["jax"]
