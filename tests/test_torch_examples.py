"""The port's examples (examples_torch/) import nothing of jax or tpudsp:
each module is imported, by path, in a fresh interpreter of its own. They
run on the card only, in chip_smoke.py's stream phase."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (ROOT / "examples_torch").glob("*.py"))

_PROBE = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("example", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(m for m in sys.modules if m in ("jax", "tpudsp")
                        or m.startswith(("jax.", "tpudsp.")))))
"""


def test_every_example_has_its_port():
    assert EXAMPLES == sorted(p.name for p in (ROOT / "examples").glob("*.py"))


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_imports_no_jax(example):
    res = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT / "examples_torch" / example)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
