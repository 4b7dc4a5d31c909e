"""The port stands alone: no JAX, nothing of the JAX package.

  * ``repro_torch`` and every module under it import in a fresh interpreter
    in which ``jax`` cannot be imported;
  * so do the port's examples and dev smokes (``examples/torch_*.py``,
    ``scripts/torch_smoke_*.py``), which run nothing on import;
  * an AST scan of ``src/repro_torch/``, ``chip_smoke.py`` and those scripts
    finds no import of ``jax``, ``jaxlib``, ``repro`` or ``repro.*``
    (``repro_torch`` is fine);
  * importing the kernel packages builds nothing (no ``nvcc`` here).
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
SCRIPTS = sorted(ROOT.glob("examples/torch_*.py")) + sorted(ROOT.glob("scripts/torch_smoke_*.py"))
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + SCRIPTS
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [
        (line, mod)
        for line, mod in _imports(path)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_modules_import_with_jax_blocked():
    assert len(SCRIPTS) == 7, SCRIPTS
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import importlib.util\n"
        f"for p in {[str(p) for p in SCRIPTS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('script', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._loaded\n"
        "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
