"""Each control of the comparison comes out not correct: the reference put
in the program's place and computed below the configurations' float32
(TF32 products; float16 between stages; TF32 products and bfloat16 between
stages), judged by each cell's own number and limit.

On the CPU at a size a test run holds; on the card (marker ``card``) at
each one-card cell's own size on three seeds, as the limits were set."""

from __future__ import annotations

import pytest

from bench_gpu import calibrate, registry
from bench_gpu.reference.precision import CONTROLS

SMALL = {
    "am.c64.b4m": {"traffic": {"block_len": 160000, "ring_blocks": 2},
                   "params": {"judge_prefix_s": 0.45}},
    "chbank.fm.i16.b16m": {"config": {"channelizer": {"nchan": 64, "iq_rate": 6.25e6}},
                           "traffic": {"block_len": 65536, "ring_blocks": 2, "channels": 64,
                                       "amplitude": 0.01, "iq_rate": 6.25e6}},
    "chbank.cam.i16.b16m": {"config": {"channelizer": {"nchan": 64, "iq_rate": 6.25e6}},
                            "traffic": {"block_len": 64 * 4096, "ring_blocks": 2,
                                        "channels": 64, "amplitude": 0.01,
                                        "iq_rate": 6.25e6},
                            "params": {"judge_prefix_s": 0.1}},
}
ONE_CARD = [w["name"] for w in registry.benchmark()["workloads"] if w["chips"] == 1]


def _limits(cell):
    p = registry.workload(cell)["params"]
    return {k[len("limit_"):]: v for k, v in p.items() if k.startswith("limit_")}


def _fails(reading, cell):
    lim = _limits(cell)
    return any(reading["checks"][k] > v for k, v in lim.items())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_on_the_cpu(cell):
    rs = calibrate.control_readings(cell, 2**31 + 77, device="cpu", overrides=SMALL[cell])
    assert [r["precision"] for r in rs] == [p.name for p in CONTROLS]
    for r in rs:
        assert _fails(r, cell), r


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_fails_on_the_card_at_the_cells_size(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "python3 -m pytest bench_gpu/tests -m card")
    for seed in (2**31 + 501, 2**31 + 502, 2**31 + 503):
        for r in calibrate.control_readings(cell, seed):
            assert _fails(r, cell), r
