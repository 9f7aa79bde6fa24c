"""run.py without a card: it fails with its reason and prints no result."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from bench_gpu import registry

ROOT = registry.ROOT


def _run(cwd, *args):
    return subprocess.run([sys.executable, "bench_gpu/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()


@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark()["workloads"]])
def test_no_card_no_result(cell):
    if _has_card():
        pytest.skip("this machine has a card")
    r = _run(ROOT, "--workload", cell, "--seed", str(2**31 + 3), "--seconds", "1",
             "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""
    assert "card" in r.stderr


def test_unknown_workload_fails():
    r = _run(ROOT, "--workload", "no.such.cell", "--seed", "1", "--seconds", "1")
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files (no
    program) gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_gpu", tmp_path / "bench_gpu",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    r = _run(tmp_path, "--workload", "am.c64.b4m", "--seed", "5", "--seconds", "1")
    assert r.returncode != 0 and r.stdout == ""
