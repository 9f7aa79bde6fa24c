"""stage_run.py on the CPU: the harness's run with the span window before
its profiled window, around a stand-in program with the AM chain's spans
(the card's device events are what only a card run gives)."""

from __future__ import annotations

import time

from bench_gpu import harness, stage_run, stages
from bench_gpu.tests.test_bench_gpu_control import SMALL


class _Spanned:
    """A few cheap ops under AMReceiver.step and its two stage spans."""

    def __init__(self, prog):
        from tpudsp_torch.utils.profiling import annotate
        self.annotate, self.prefix_blocks, self.target = annotate, 0, prog.target
        self.prog = prog

    def work(self):
        return self.prog.work()

    def __call__(self, block):
        with self.annotate("AMReceiver.step"):
            with self.annotate("am_step.front"):
                y = block[:64].abs()
            with self.annotate("am_step.back"):
                y = y.cumsum(0)
            return y * 2.0


def test_stage_run_reads_the_span_window():
    ov = dict(SMALL["am.c64.b4m"])
    ov["params"] = dict(ov["params"], warm_blocks=1)
    run = stage_run.StageRun("am.c64.b4m", 2**31 + 99, 0.2, True, time.perf_counter(),
                             device="cpu", overrides=ov, wrap=_Spanned)
    res = stage_run.stage_result(run, run.run())
    st = res["stages"]
    assert set(st["table"]) == {"AMReceiver.step", "am_step.front", "am_step.back"}
    assert all(v["count"] == harness.TRACED_BLOCKS for v in st["table"].values())
    assert set(st["host_ms"]) == set(stages.ROLES) and all(v > 0 for v in st["host_ms"].values())
    assert st["host_sum_ms"] <= st["span_window_host_ms"]
    assert st["stage_cover"] == 0.0 and st["device_ms"]["demod"] is None   # no card
    assert "correct" not in res and "breakdown" in res
