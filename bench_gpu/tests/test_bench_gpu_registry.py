"""Every cell, configuration, traffic mix, hand kernel and per-layer metric
is found by its name, BENCHMARK.json keeps to its schema, and one more of
each needs only new files and new entries."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from bench_gpu import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_gpu"]
    assert BENCH["command"] == ["python3", "bench_gpu/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[k]]
        assert len(got) == len(set(got))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:       # every cell listed reports what it moves
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in next(e for e in BENCH["end_to_end"]
                             if e["name"] == m["moves"]).get("workloads", cells)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = registry.workload(cell)
    assert registry.config(c["config"])["name"] == c["config"]
    mix = registry.traffic(c["traffic"])
    assert mix["format"] in ("c64", "i16") and mix["signal"] in ("am", "fm")
    ent = registry.entry(c["entry"])
    assert callable(ent.build) and callable(ent.judge) and callable(ent.reference)
    assert any(m["name"] == "setup_s" for m in c["end_to_end"]) and len(c["end_to_end"]) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        assert c["file"] == f"bench_gpu/configs/{c['name']}.json"
        f = registry.config(c["name"])
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_hand_kernels_name_their_counters():
    for name, spec in registry.kernels().items():
        assert spec["trace"] and spec["counters"]
        for c in spec["counters"]:
            from bench_gpu.harness import read_counter
            assert read_counter(c) >= 0


def test_one_more_of_each_needs_only_new_files(tmp_path):
    """A copy of the benchmark with one more configuration, mix, cell and
    metric: only new files and new entries, and all found by name."""
    root = tmp_path
    shutil.copytree(registry.HERE, root / "bench_gpu")
    bench = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
    here = root / "bench_gpu"
    (here / "configs" / "extra-config.json").write_text(json.dumps({"name": "extra-config"}))
    (here / "traffic" / "extra.mix.json").write_text(json.dumps({"format": "c64"}))
    (here / "cells" / "extra.cell.json").write_text(
        json.dumps({"entry": "am_receiver", "params": {}}))
    (here / "metrics" / "extra.metric.py").write_text("def read(ctx):\n    return 1.0\n")
    bench["workloads"].append({"name": "extra.cell", "config": "extra-config",
                               "traffic": "extra.mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "extra.metric", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "chain step",
                               "moves": "samples_per_s", "workloads": ["extra.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = registry.workload("extra.cell", root=root, here=here)
    assert registry.config(c["config"], here=here)["name"] == "extra-config"
    assert registry.traffic(c["traffic"], here=here)["format"] == "c64"
    assert [m["name"] for m in c["per_layer"]][-1] == "extra.metric"
    assert registry.metric("extra.metric", here=here).read({}) == 1.0
    with pytest.raises(KeyError):
        registry.workload("no.such.cell", root=root, here=here)
