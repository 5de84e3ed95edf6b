"""The PyTorch port stands alone: no module of tpusched_torch, and not
chip_smoke.py, imports JAX, optax or anything of the tpusched package (the
machine with the card has none of them)."""
from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "tpusched_torch"
MODULES = sorted(p.stem for p in PACKAGE.glob("*.py") if p.stem != "__init__")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top in ("tpusched", "optax")


def test_every_module_imports_without_jax_or_tpusched():
    prog = (
        "import importlib, sys\n"
        f"for m in {['tpusched_torch'] + ['tpusched_torch.' + m for m in MODULES]!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('tpusched', 'optax') or m.split('.')[0].startswith('jax')))\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py"]
                         + sorted(PACKAGE.glob("*.py")),
                         ids=lambda p: p.name)
def test_source_names_no_jax_or_tpusched_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_chip_smoke_imports_the_port():
    assert any(m.split(".")[0] == "tpusched_torch"
               for m in _imports(ROOT / "chip_smoke.py"))
