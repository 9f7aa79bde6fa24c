"""The port's scaling harness (``tpudsp_torch.bench_scaling``) on CPU
ranks: started by torchrun with two gloo ranks, as on the cards with one
process a card, it measures the bank, scanner and channelizer flagships at
one and two ranks and writes its rows where ``--json`` says, never to the
JAX package's SCALING.json. The numbers are CPU-process timings (each row
says so), not a card figure; the card's rows come from the same entry
point with ``--device cuda``, the default."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from tpudsp_torch import bench_scaling

ROOT = Path(__file__).resolve().parent.parent


def test_two_cpu_ranks_under_torchrun(tmp_path):
    out = tmp_path / "rows.json"
    scaling = (ROOT / "SCALING.json").read_bytes()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "tpudsp_torch.bench_scaling", "4", "15", "--device", "cpu",
         "--only", "bank,scanner,tp", "--json", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = json.loads(out.read_text())
    got = {(r["flagship"], r["shards"]) for r in rows}
    assert got == {(f, n) for f in ("bank", "scanner", "tp") for n in (1, 2)}
    for r in rows:
        assert r["platform"] == "cpu" and r["card"] is None and "not a card figure" in r["caveat"]
        assert r["n_ranks"] == 2 and r["samples_per_s"] > 0 and r["cuda_event_ms"] is None
        assert r["efficiency_vs_1rank"] == pytest.approx(
            r["samples_per_s"] / (r["shards"] * next(
                b["samples_per_s"] for b in rows
                if b["flagship"] == r["flagship"] and b["shards"] == 1)))
    assert (ROOT / "SCALING.json").read_bytes() == scaling


def test_scaling_json_is_refused():
    with pytest.raises(SystemExit):
        bench_scaling.parse(["--json", str(ROOT / "SCALING.json")])


def test_one_rank_without_a_launcher(tmp_path, monkeypatch):
    """No launcher: one rank, a LocalMesh; a block too short for the AM
    receiver's warmup is a skipped row, as the JAX harness reports it."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    out = tmp_path / "rows.json"
    assert bench_scaling.main(["4", "14", "--device", "cpu", "--only", "am,tp",
                               "--json", str(out)]) == 0
    rows = {r["flagship"]: r for r in json.loads(out.read_text())}
    assert "warmup" in rows["am"]["skipped"] and rows["tp"]["shards"] == 1
