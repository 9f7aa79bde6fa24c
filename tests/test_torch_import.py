"""The port imports torch and never jax (nor the JAX package)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
# every module of the package, from its files (the package first)
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "tpudsp_torch").rglob("*.py"))

# imports every module in turn in one fresh interpreter and records, after
# each, which forbidden modules are loaded
_PROBE = """
import importlib, json, sys
out = {}
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
    out[name] = sorted(m for m in sys.modules if m in ("jax", "tpudsp")
                       or m.startswith(("jax.", "tpudsp.")))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def loaded():
    res = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(MODULES)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_port_imports_no_jax(loaded, module):
    assert loaded[module] == [], f"importing {module} loaded {loaded[module]}"


@pytest.mark.parametrize("entry", ["tpudsp_torch", "tpudsp_torch.compat",
                                   "tpudsp_torch.parallel"])
def test_entry_point_alone_imports_no_jax(entry):
    """Each entry point in a fresh interpreter of its own: the sharded
    runtime's (torch.distributed) as well as the receiver's and the class
    surface's."""
    res = subprocess.run([sys.executable, "-c", _PROBE, json.dumps([entry])],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])[entry] == []


def test_convert_leaves_the_sharded_runtime_unloaded():
    """The state converter loads the sharded runtime only when a sharded
    receiver's state is converted."""
    code = ("import sys, tpudsp_torch.convert; "
            "print(sorted(m for m in sys.modules if m.startswith('tpudsp_torch.parallel')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
