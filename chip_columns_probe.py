#!/usr/bin/env python3
"""Where the column carry's kernel spends its time, on one NVIDIA GPU.

    python3 chip_columns_probe.py

Run from the root of a checkout on a machine with a CUDA device and the
CUDA toolkit. It builds copies of csrc/first_order_scan.cu into
tpudsp_torch/_build/probe/, each with one phase of first_order_scan_cols
cut out: the copies of x's columns into shared memory ('no load': zeros
instead), the blocks' prefixes ('no prefix') and the writes of the rows
('no store'). It holds the unchanged copy bit for bit against
kernels/iir.first_order_apply_blocked_mc at config 4's (16384, 1024)
de-emphasis and at edge shapes, then times every copy's wrapper call (CUDA
events) and its kernel's device time (torch.profiler) at (16384, 1024),
twice in turns, and prints each against the function's bound. A cut copy computes something else: its time says
what the phase costs beside the others, not what the kernel would take
without it. Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# one phase cut out: (the source's text, what takes its place)
VARIANTS = {
    "whole kernel": [],
    "no load": [("const bool in = start + r < n && c0 + g < C;", "const bool in = false;")],
    "no prefix": [("toeplitz_prefix(c, rows + lane * ROW, rows + lane * ROW);", "")],
    "no store": [("if (start + k < n) yr[start + k] = out;",
                  "if (start + k < n && out == -1.5e30f) yr[start + k] = out;")],
}


def build_variants(build) -> dict:
    """Each variant's library, built in parallel (one nvcc a source)."""
    src = (build.CSRC / "first_order_scan.cu").read_text()
    out = build.BUILD / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "tile_chain.cuh").write_text((build.CSRC / "tile_chain.cuh").read_text())
    procs = {}
    for k, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out / f"columns_{k}.cu"
        cu.write_text(text)
        so = out / f"libcolumns_{k}.so"
        procs[name] = (so, subprocess.Popen(build.command(cu, so), stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES["first_order_scan"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_columns_probe.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tpudsp_torch.chains import channelizer as tch
    from tpudsp_torch.cuda import build
    from tpudsp_torch.cuda import first_order as fo
    from tpudsp_torch.design import iirdes
    from tpudsp_torch.kernels import iir as kiir
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    libs = build_variants(build)
    b0, a = iirdes.deemphasis_coeffs(tch.ChannelizerConfig().chan_rate)
    rng = np.random.default_rng(62)
    x = torch.from_numpy(rng.standard_normal((16385, 1024)).astype(np.float32)).cuda()
    y0 = torch.from_numpy(rng.standard_normal(1024).astype(np.float32)).cuda()
    main_x = x[:16384].contiguous()
    with cs.library_swapped("first_order_scan", libs["whole kernel"]):
        for n, c in ((16384, 1024), (2049, 1021), (33, 1000), (16385, 1024)):
            xe = x[:n, :c].contiguous()
            same = cs._bits_equal(fo.first_order_apply_blocked_mc(b0, a, y0[:c], xe),
                                  kiir.first_order_apply_blocked_mc(b0, a, y0[:c], xe))
            print(f"whole kernel ({n}, {c}) bit-equal to its plain version: {same}", flush=True)
            if not same:
                return 1
    bound = max(main_x.numel() * 8 / cs.HBM_BPS, main_x.numel() * cs.OPS_FIRST_ORDER
                / cs.F32_FLOPS) * 1e3
    for turn in (1, 2):
        for name, lib in libs.items():
            with cs.library_swapped("first_order_scan", lib):
                call = lambda: fo.first_order_apply_blocked_mc(b0, a, y0, main_x)
                ms = cs._cuda_ms(call, 20)
                dev = cs._device_ms(call, "first_order_cols_kernel", 20)
            print(f"turn {turn}: {name} (16384, 1024): call {ms:.4f} ms, device {dev:.4f} ms, "
                  f"bound {bound:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
