"""The frozen roofline formulas against PERF.md section 6's bounds, and the
readers on a trace summary."""

from __future__ import annotations

import pytest

from bench_gpu import registry, report

PEAKS = registry.peaks()


def test_pfb_branch_bound_is_perf_sections_6():
    m = registry.metric("pfb_branch_roofline")
    ms = m.least_s({"C": 1024, "T": 12, "N": 1024 * 16384, "wire_bytes": 4}, PEAKS) * 1e3
    assert ms == pytest.approx(0.0601, abs=5e-5)
    c64 = m.least_s({"C": 1024, "T": 12, "N": 1024 * 16384, "wire_bytes": 8}, PEAKS) * 1e3
    assert c64 == pytest.approx(0.0801, abs=1e-4)


def test_am_front_scan_bound_is_perf_sections_6():
    m = registry.metric("am_front_scan_roofline")
    assert m.least_s({"samples": 96000}, PEAKS) * 1e3 == pytest.approx(0.000459, abs=1e-6)
    assert m.least_s({"samples": 1024 * 16384}, PEAKS) * 1e3 == pytest.approx(0.0801, abs=1e-4)


def _ctx(seconds, counts_ok=True, blocks=24):
    tr = {"hand": {"am_front_scan": {"trace": blocks, "seconds": seconds}},
          "counts_ok": counts_ok, "ops": {"am_front_scan_kernel": [blocks, seconds + 0.012]},
          "busy_s": 0.9, "window_s": 1.0, "kernels": 10 * blocks}
    return {"blocks": blocks, "trace": tr, "work": {"am_front_scan": {"samples": 96000}},
            "peaks": PEAKS, "host_ms": 1.0}


def test_roofline_reader_share_and_silence():
    m = registry.metric("am_front_scan_roofline")
    least = m.least_s({"samples": 96000}, PEAKS)
    assert m.read(_ctx(24 * least * 100.0)) == pytest.approx(1.0)
    assert m.read(_ctx(0.0)) is None                 # nothing to read: no number
    assert m.read(_ctx(1.0, counts_ok=False)) is None
    assert registry.metric("pfb_branch_roofline").read(_ctx(1.0)) is None
    assert registry.metric("device.idle_pct").read(_ctx(1.0)) == pytest.approx(10.0)
    assert registry.metric("chain.launches").read(_ctx(1.0)) == 10.0
    assert registry.metric("ops.torch_ms").read(_ctx(1.0)) == pytest.approx(0.5)


def test_a_cell_class_twin_is_its_bases_reader():
    """chain.launches.am moves samples_per_s.am: chain.launches's reader."""
    twins = [m for m in registry.benchmark()["per_layer"] if "." in m["moves"]]
    assert twins
    for m in twins:
        cls = m["moves"].partition(".")[2]
        base = m["name"][:-len(cls) - 1]
        assert m["name"].endswith("." + cls)
        assert registry.metric(m["name"]).read is not None
        assert registry.metric(m["name"]).__name__ == registry.metric(base).__name__


def test_a_share_above_100_fails_the_run():
    res = {"metrics": {"am_front_scan_roofline": {"value": 100.5, "unit": "%"},
                       "pfb_branch_roofline": {"value": 70.0, "unit": "%"}}}
    assert len(report.roofline_faults(res)) == 1
