"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py``, the
port's measurement tools and its walkthroughs (``examples/torch``) import
neither JAX nor the JAX package ``repro``."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples" / "torch").glob("*.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "tools" / name for name in ("kernel_ab.py", "serve_ab.py")
] + EXAMPLES


def _module(path: Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    modules = [_module(p) for p in SOURCES if p.is_relative_to(PORT)]
    examples = [str(p) for p in EXAMPLES]
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({examples!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'n': len(sys.modules), 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert len(modules) >= 20 and len(examples) == 7


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_statement(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"
