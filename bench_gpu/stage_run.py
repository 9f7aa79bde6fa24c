"""Run one cell with its chain's stage spans read back.

    python3 bench_gpu/stage_run.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout on a machine with a card. It runs the cell as
``run.py --trace 1`` does (set-up, the measured window, the profiled
window), with a span window (``stages.span_window``) between the measured
and the profiled window, and reads each device event of the profiled
window to the stage that launched it (``stages.assign``). It prints one
JSON object as the last line of standard output: what ``run.py --trace 1``
reports but the check against the reference, and ``stages``: each role's
host and device ms a block, the measured window's ``chain_host_ms`` beside
the span window's host ms a block (the spans' cost when on), the share of
device time assigned and the recorder's table.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_gpu import harness, report, stages, trace  # noqa: E402


class StageRun(harness.Run):
    """The harness's run with a span window before the profiled window,
    and the profiled window's events also read by ``stages.assign``."""

    def traced_window(self, prog, g: int) -> dict:
        self.spans = stages.span_window(self, prog, g)
        g += harness.TRACED_BLOCKS      # whole turns of the ring: the same slot
        summarize = trace.summarize

        def both(events, kernels):
            events = list(events)
            self.stages = stages.assign(events)
            return summarize(events, kernels)

        trace.summarize = both
        try:
            return super().traced_window(prog, g)
        finally:
            trace.summarize = summarize


def stage_result(run: StageRun, part: dict) -> dict:
    res = harness.result(run, part, [])
    for k in ("correct", "failed", "checks"):
        res.pop(k)
    blocks = harness.TRACED_BLOCKS
    host = stages.host_ms(run.spans)
    device = stages.device_ms(run.stages, blocks)
    total = sum(c[1] for c in part["trace"]["ops"].values())
    res["stages"] = {
        "host_ms": host,
        "host_sum_ms": sum(v for v in host.values() if v is not None),
        "chain_host_ms": part["host_ms"],
        "span_window_host_ms": run.spans["host_ms"],
        "device_ms": device,
        "device_sum_ms": sum(v for v in device.values() if v is not None),
        "device_total_ms": total * 1e3 / blocks,
        "stage_cover": run.stages["stage_cover"],
        "launches_unmatched": run.stages["launches_unmatched"],
        "table": run.spans["table"],
    }
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        report.log("stages: no CUDA card; this runs on the card only")
        return 2
    run = StageRun(args.workload, args.seed, args.seconds, True, time.perf_counter())
    print(json.dumps(stage_result(run, run.run())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
