"""Nothing under bench_gpu/ imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level names are compared whole:
tpudsp_torch begins with tpudsp and is not it."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpudsp"}
MODULES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_walk_finds_the_modules():
    assert len(MODULES) > 20 and HERE / "harness.py" in MODULES


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "tpudsp_torch" not in names and "bench_gpu" not in names


def test_whole_name_comparison():
    from bench_gpu.report import forbidden_modules
    import sys
    import types
    sys.modules.setdefault("tpudsp_torch_probe", types.ModuleType("tpudsp_torch_probe"))
    assert "tpudsp" not in forbidden_modules()
