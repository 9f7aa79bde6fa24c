#!/usr/bin/env python3
"""Where csrc/biquad_scan.cu's time goes, on one NVIDIA GPU.

    python3 chip_biquad_probe.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (nvcc). Prints the card's name and power limit, then one JSON
line for each of:

1. sections -- the kernel's device time (torch.profiler, mean of 20
   launches) at its main shape (CLowpassIIR(order=8, Fc=0.0075,
   mode="scan") on a 2^18-sample complex64 callback) with 1, 2, 4 and 8
   of the design's sections (8: the 4 twice), and at BroadcastAM's DC block
   (6291 real samples) with 1 and 2: what a section costs, and the rest;
2. geometry -- copies of the source at other block and tile sizes (L
   samples a thread, TB threads a tile; the fold window stays TB tiles),
   built into tpudsp_torch/_build/probe/, each held bit for bit against the
   plain version (kernels/iir with its constants set to match) and timed
   by CUDA events (the launch alone, 50 launches) and by the profiler;
3. timeline -- a copy with %globaltimer stamps taken by each block's
   thread 0 (or its last thread) at the main shape: per section, the
   spread of the tiles' starts and of their aggregates' publishing, and
   for the last tile of each row its last link read, its warps' sums and
   its entry, in us from the first start. The stamps' resolution is the
   card's %globaltimer step (~0.26 us on the H100).

Exits non-zero when no CUDA device is present or a copy disagrees with
its plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GEOMETRIES = ((16, 128), (8, 128), (16, 64), (16, 256), (8, 256))
# (text of the source, text put before it) of each stamp of the timeline
STAMPS = (
    ("    // a link per tile (its aggregate), then one per window (its entry)\n",
     "    if (b == 0) STAMP(0) = gtime();\n"),
    ("    __syncthreads();\n    // 3. the tile's entry:",
     "    if (b == TB - 1) STAMP(1) = gtime();\n"),
    ("#pragma unroll\n      for (int d = 16; d > 0; d /= 2) f = add(f, shfl_down(f, d));\n",
     "      if (b < j) atomicMax(reinterpret_cast<unsigned long long*>(&STAMP(2)),\n"
     "                           static_cast<unsigned long long>(gtime()));\n"),
    ("      V2 f = tot[0];\n", "      STAMP(3) = gtime();\n"),
    ("    // 4. this block's entry,", "    if (b == 0) STAMP(4) = gtime();\n"),
)
NAMES = ("start", "aggregate out", "last link read", "warp sums", "entry")
MAX_BLOCKS, MAX_SECTIONS = 512, 8


def source() -> str:
    return (ROOT / "tpudsp_torch" / "csrc" / "biquad_scan.cu").read_text()


def resized(src: str, L: int, TB: int) -> str:
    """The source at L samples a thread and TB threads a tile."""
    for old, new in (("constexpr int L = 16;", f"constexpr int L = {L};"),
                     ("constexpr int TB = 128;", f"constexpr int TB = {TB};")):
        if src.count(old) != 1:
            raise AssertionError(f"the source no longer has {old!r}")
        src = src.replace(old, new)
    return src


def stamped(src: str) -> str:
    """The source with the timeline's stamps and an entry that reads them."""
    for at, stamp in STAMPS:
        if src.count(at) != 1:
            raise AssertionError(f"the source no longer has {at!r}")
        src = src.replace(at, stamp + at)
    n = MAX_BLOCKS * MAX_SECTIONS * len(NAMES)
    src = src.replace('#include "tile_chain.cuh"', f'''#include "tile_chain.cuh"
__device__ long long g_stamp[{n}];
__device__ __forceinline__ long long gtime() {{
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define STAMP(k) g_stamp[((id < {MAX_BLOCKS} ? id : {MAX_BLOCKS - 1}) * {MAX_SECTIONS} + \\
                          (s < {MAX_SECTIONS} ? s : {MAX_SECTIONS - 1})) * {len(NAMES)} + (k)]''', 1)
    return src + f'''
extern "C" int read_stamps(long long* h) {{
  return static_cast<int>(cudaMemcpyFromSymbol(h, g_stamp, sizeof(long long) * {n}));
}}
'''


@contextlib.contextmanager
def geometry(kiir, L: int, TB: int):
    """kernels/iir's constants set for a copy at (L, TB), then restored."""
    names = ("SOS_L", "SOS_TB", "SOS_TILE", "SOS_WINDOW", "SOS_NPOW", "SOS_SAMPLE_POW",
             "SOS_TILE_POW", "SOS_WIDTH")
    saved = {k: getattr(kiir, k) for k in names}
    npow = 2 * TB + L
    values = (L, TB, L * TB, TB, npow, TB - 1, TB + L, kiir.SOS_HEAD + 8 * npow)
    for k, v in zip(names, values):
        setattr(kiir, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(kiir, k, v)


def build(name: str, src: str):
    """``src`` built as tpudsp_torch/_build/probe/lib<name>.so and loaded;
    (library, ptxas's registers and spills)."""
    from tpudsp_torch.cuda import build as b
    out = b.BUILD / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "tile_chain.cuh").write_text((b.CSRC / "tile_chain.cuh").read_text())
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    res = subprocess.run(b.command(cu, so), capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.biquad_scan.argtypes = b.SIGNATURES["biquad_scan"]["biquad_scan"]
    return lib, re.findall(r"Used \d+ registers|\d+ bytes spill stores", res.stderr)


def launcher(lib, kiir, tab, st, x):
    """A call of the copy ``lib`` on (tab, st, x), as cuda/biquad_scan
    calls the kernel, with a scratch buffer of its own."""
    import torch
    n, S = x.shape[0], tab.shape[0]
    rows, rs, cs = (2, 1, 2) if x.is_complex() else (1, n, 1)
    tiles = -(-n // kiir.SOS_TILE)
    links = S * rows * (tiles + -(-tiles // kiir.SOS_WINDOW))
    scratch = torch.zeros(4 + 8 * links, dtype=torch.int32, device=x.device)
    count = {"base": 0, "epoch": 0}

    def call():
        y, last = torch.empty_like(x), torch.empty_like(st)
        count["epoch"] += 1
        rc = lib.biquad_scan(tab.data_ptr(), x.data_ptr(), st.data_ptr(), y.data_ptr(),
                             last.data_ptr(), scratch.data_ptr(), S, rows, n, rs, cs,
                             count["base"], count["epoch"], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        count["base"] += rows * tiles
        return last, y
    return call, rows * tiles


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_biquad_probe.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tpudsp_torch.cuda import biquad_scan
    from tpudsp_torch.kernels import iir as kiir
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    cases = cs.biquad_cases()
    part = "biquad_scan_kernel"
    sections = {}
    for label, sos, st, x in cases:
        tab = torch.from_numpy(kiir.sos_table(sos)).to(x.device)
        for S in ((1, 2, 4, 8) if x.is_complex() else (1, 2)):
            pick = torch.arange(S, device=x.device) % len(sos)
            t, s0 = tab[pick].contiguous(), st[pick].contiguous()
            sections[f"{label} S={S}"] = cs._device_ms(
                lambda: biquad_scan.sos_apply_df(t, s0, x), part, 20)
    print(json.dumps({"sections_device_ms": sections}), flush=True)
    ok = True
    for L, TB in GEOMETRIES:
        lib, ptxas = build(f"biquad_{L}_{TB}", resized(source(), L, TB))
        row = {"L": L, "TB": TB, "ptxas": ptxas}
        with geometry(kiir, L, TB):
            for label, sos, st, x in cases:
                tab = torch.from_numpy(kiir.sos_table(sos)).to(x.device)
                call, blocks = launcher(lib, kiir, tab, st, x)
                kl, ky = call()
                rl, ry = kiir.sos_apply_df(tab, st, x)
                equal = torch.equal(ky, ry) and torch.equal(kl, rl)
                ok &= equal
                row[label] = {"blocks": blocks, "bit_equal": equal,
                              "events_ms": cs._cuda_ms(call, 50),
                              "device_ms": cs._device_ms(call, part, 20)}
        print(json.dumps({"geometry": row}), flush=True)
    lib, _ = build("biquad_stamped", stamped(source()))
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    label, sos, st, x = cases[0]
    tab = torch.from_numpy(kiir.sos_table(sos)).to(x.device)
    call, blocks = launcher(lib, kiir, tab, st, x)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    h = np.zeros(MAX_BLOCKS * MAX_SECTIONS * len(NAMES), np.int64)
    lib.read_stamps(h.ctypes.data)
    S, tiles = len(sos), blocks // 2
    h = h.reshape(MAX_BLOCKS, MAX_SECTIONS, len(NAMES))[:blocks, :S].astype(np.float64)
    h = (h - h[:, 0, 0].min()) / 1e3
    line = []
    for s in range(S):
        for r in range(2):
            t = h[r * tiles:(r + 1) * tiles, s]
            line.append({"section": s, "row": r,
                         "starts_us": [t[:, 0].min(), t[:, 0].max()],
                         "aggregates_us": [t[:, 1].min(), t[:, 1].max()],
                         "last tile": dict(zip(NAMES[2:], t[-1, 2:].tolist()))})
    print(json.dumps({"timeline": line, "blocks": blocks}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
