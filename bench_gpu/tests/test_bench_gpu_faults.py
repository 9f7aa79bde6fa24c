"""A run with the timed path broken underneath must come out not correct.

Each test drives the rest of a run (the ring from the seed, the program,
the warm blocks, the window, the judged pair against the float64
reference) on the CPU at a size a test run holds, with the port's plain
versions standing in for the kernels, past the harness's look for a card.
The sound run comes out correct; each fault the cell can have comes out
not correct: a step that returns its state unchanged, half of the batch
left out, and one answer altered where it is produced.
"""

from __future__ import annotations

import time

import pytest

from bench_gpu import harness
from bench_gpu.tests import faults

SEED = 2**31 + 101

# each cell at a size the CPU runs in seconds: the same channel rate and
# the same de-emphasis, DC tracker and loop memories as the cell
SMALL = {
    # a ring of one block: the judged pair comes as soon as the prefix has
    # run (the plain front scan takes seconds a block on the CPU); the
    # prefix is 0.9 s, as 0.45 s leaves the DC tracker's start at -87 dB
    "am.c64.b4m": (50.0, {"traffic": {"block_len": 160000, "ring_blocks": 1},
                         "params": {"warm_blocks": 1, "judge_prefix_s": 0.9}}),
    "chbank.fm.i16.b16m": (3.0, {"config": {"channelizer": {"nchan": 64, "iq_rate": 6.25e6}},
                                 "traffic": {"block_len": 65536, "ring_blocks": 2, "channels": 64,
                                             "amplitude": 0.01, "iq_rate": 6.25e6},
                                 "params": {"warm_blocks": 1}}),
}


@pytest.fixture(autouse=True)
def _cpu_default(monkeypatch):
    from tpudsp_torch.ops import base
    monkeypatch.setattr(base, "DEFAULT_DEVICE", "cpu")


def _run(cell, wrap=None):
    seconds, ov = SMALL[cell]
    res, checks = harness.run_single(cell, SEED, seconds, False, time.perf_counter(),
                                     device="cpu", overrides=ov, wrap=wrap)
    return res, checks


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    res, checks = _run(cell)
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, fault):
    res, checks = _run(cell, getattr(faults, fault))
    assert "judged_pair" not in res["checks"], checks    # the pair was judged...
    assert not res["correct"], checks                     # ... and failed
    assert res["failed"] == harness.JUDGED_BLOCKS

