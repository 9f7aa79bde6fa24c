"""Find a cell, a configuration, a traffic mix, an entry, a hand kernel or
a per-layer metric by its name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration,
traffic and chips and each metric; the files beside this module hold the
rest, one file a name:

- ``cells/<cell>.json``: the entry that drives the program and its
  parameters (``entry``, ``params``);
- ``configs/<config>.json``: the deployment's sizes, as the program runs it;
- ``traffic/<mix>.json``: the parameters ``signals`` makes the ring from;
- ``entries/<entry>.py``: ``build`` and ``judge`` for one entry of the port;
- ``kernels/<kernel>.json``: a hand kernel's names in the profiler's trace
  and the wrapper counters that count its launches;
- ``metrics/<metric>.py``: ``read(ctx)``, one per-layer metric. A metric
  ``<base>.<class>`` that moves an end-to-end metric of that class (as
  ``chain.launches.am`` moves ``samples_per_s.am``, the AM cell's rate
  under its own bound) and has no file of its own is ``<base>``'s reader.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(name: str, root: Path = ROOT, here: Path = HERE) -> dict:
    """The cell ``name``: its BENCHMARK.json entry merged with its cell file,
    and the end-to-end and per-layer metrics it reports."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(cells))})")
    cell = dict(cells[name])
    cell.update(_json(here / "cells" / f"{name}.json"))
    reports = lambda m: name in m.get("workloads", [name])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if reports(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if reports(m)]
    return cell


def config(name: str, here: Path = HERE) -> dict:
    return _json(here / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return _json(here / "traffic" / f"{name}.json")


def entry(name: str, here: Path = HERE):
    return _module(here / "entries" / f"{name}.py", f"bench_gpu_entry_{name}")


def metric(name: str, here: Path = HERE, root: Path = ROOT):
    path = here / "metrics" / f"{name}.py"
    if not path.is_file():
        m = next((m for m in benchmark(root)["per_layer"] if m["name"] == name), None)
        cls = m["moves"].partition(".")[2] if m else ""
        if cls and name.endswith("." + cls):
            return metric(name[:-len(cls) - 1], here, root)
    return _module(path, "bench_gpu_metric_" + name.replace(".", "_").replace("-", "_"))


def peaks(here: Path = HERE) -> dict:
    """The card's published peaks the roofline shares are taken against."""
    return _json(here / "peaks.json")


def kernels(here: Path = HERE) -> dict:
    """Every hand kernel's file, by name."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((here / "kernels").glob("*.json"))}
