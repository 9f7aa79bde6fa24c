"""The readings that the limits of ``correct`` are set from: the program's
number on many seeds, and the control's on a few.

    python3 bench_gpu/calibrate.py --workload <cell> --seeds <a,b,...>
        [--control-seeds <x,y,...>] [--seconds <s>]

For each of ``--seeds`` it runs the cell in this process as a run does
(the ring from the seed, the program built, the warm blocks, a short
window of ``--seconds``) and judges the seed's pair against the float64
reference. For each of ``--control-seeds`` it puts each control in the
program's place: the reference computed below the configuration's float32
(TF32 products; float16 between stages; TF32 products and bfloat16 between
stages: ``reference.precision.CONTROLS``), judged by the same comparison at
the cell's own size. One JSON line a reading on standard output.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def program_reading(cell: str, seed: int, seconds: float, device=None, overrides=None):
    import torch

    from bench_gpu import harness
    run = harness.Run(cell, seed, seconds, False, time.perf_counter(), device=device,
                      overrides=overrides)
    part = run.run()
    checks = run.judge()
    del run
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"kind": "program", "seed": seed, "blocks": part["blocks"],
            "checks": {c["name"]: c["value"] for c in checks}}


def control_readings(cell: str, seed: int, device=None, overrides=None):
    """One reading a control of ``CONTROLS``, on the seed's judged ring slot,
    against one float64 reference."""
    import numpy as np
    import torch

    from bench_gpu import harness, signals
    from bench_gpu.reference.precision import CONTROLS, F64
    run = harness.Run(cell, seed, 0.0, False, 0.0, device=device, overrides=overrides)
    R = int(run.mix["ring_blocks"])
    j = int(np.random.default_rng(signals.rng_seed(seed) ^ 0x5EED).integers(R))
    ring = signals.make_ring(run.mix, seed, run.device)
    g0 = j + R * 64
    ent = run.entry
    ref = ent.reference(run.cfg, run.params, run.mix, ring, g0, run.device, F64)
    out = []
    for prec in CONTROLS:
        ctl = ent.reference(run.cfg, run.params, run.mix, ring, g0, run.device, prec)
        checks = ent.compare(ref, ctl, run.params)
        out.append({"kind": "control", "precision": prec.name, "seed": seed,
                    "checks": {c["name"]: c["value"] for c in checks}})
    del ring
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for s in seeds:
        print(json.dumps(dict(program_reading(args.workload, s, args.seconds),
                              workload=args.workload)), flush=True)
    for s in [int(s) for s in args.control_seeds.split(",") if s]:
        for r in control_readings(args.workload, s):
            print(json.dumps(dict(r, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
