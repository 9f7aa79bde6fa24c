"""Run one cell of the port's benchmark once.

    python3 bench_gpu/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
It prints each number the check compares beside its limit as the last
lines of standard error, and the result as one JSON object, the last line
of standard output. With no CUDA card, or fewer cards than the cell asks
for, it prints the reason, exits with another code than 0 and prints no
result: there is no CPU fallback.
"""

import time

_T0 = time.perf_counter()   # set-up is timed from the process's start


def _since_start() -> float:
    """Seconds since this process started, from /proc (0 where unreadable)."""
    import os
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T0 -= _since_start()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    marks = [("python", time.perf_counter())]
    from bench_gpu import registry, report
    cell = registry.workload(args.workload)
    chips = int(cell["chips"])
    marks.append(("load the cell", time.perf_counter()))
    import torch
    marks.append(("import torch", time.perf_counter()))
    if not torch.cuda.is_available():
        report.log("bench: no CUDA card (torch.cuda.is_available() is false); the benchmark "
                   "runs on the card only")
        return 2
    if torch.cuda.device_count() < chips:
        report.log(f"bench: {args.workload} needs {chips} cards, this machine has "
                   f"{torch.cuda.device_count()}")
        return 2
    if chips > 1:
        report.log(f"bench: {args.workload} asks for {chips} cards; this harness runs "
                   f"one-card cells only")
        return 2
    from bench_gpu import harness
    marks.append(("find the card", time.perf_counter()))
    report.log("bench: before the run: " + ", ".join(
        f"{n} {t - p:.3f} s" for (_, p), (n, t) in zip([("", _T0)] + marks, marks)))
    res, checks = harness.run_single(args.workload, args.seed, args.seconds,
                                     bool(args.trace), _T0)
    return report.emit(res, checks)


if __name__ == "__main__":
    sys.exit(main())
