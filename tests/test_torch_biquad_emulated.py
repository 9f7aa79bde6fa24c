"""csrc/biquad_scan.cu's own source, built with g++ against CPU stand-ins
for the CUDA features it uses (tests/emulate/) and run on the host, held
bit for bit against its plain version (kernels/iir.sos_apply_df): outputs
and final states, real and complex rows, at lengths around its block and
tile, from random carried states and over chained calls.

The stand-ins run a launch's blocks one after the other in ticket order,
so this checks the kernel's arithmetic, its order of operations and its
indexing (what the card checks in chip_smoke.py, bit for bit), not its
timing: the links, the ticket and the cp.async copies are plain there.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpudsp_torch.cuda import build
from tpudsp_torch.design import iirdes
from tpudsp_torch.kernels import iir as kiir

HERE = Path(__file__).resolve().parent / "emulate"
HARD = iirdes.iirdes_sos("cheby2", "lowpass", 8, 0.0075, As=60.0, Ap=0.5)
DC_BLOCK = iirdes.iirdes_sos("cheby2", "highpass", 3, 20.0 / 48000.0, Ap=0.5, As=20.0)


def emulated_source() -> str:
    """biquad_scan.cu with its launch, its cp.async copies and its shared
    memory rewritten for the stand-ins."""
    src = (build.CSRC / "biquad_scan.cu").read_text()
    src, k = re.subn(r"(\w+)<<<([^,]+), (\w+), .*?>>>\(", r"emulate_launch(\2, \3, \1, ", src)
    assert k == 1, "one launch"
    fetch = re.search(r"__device__ __forceinline__ void fetch_row\(float\* dst, const float\* src\) "
                      r"\{.*?\n\}\n", src, re.S)
    fetched = re.search(r"__device__ __forceinline__ void fetched\(\) \{.*?\}\n", src)
    assert fetch and fetched, "fetch_row and fetched"
    src = src.replace(fetch.group(0), "__device__ __forceinline__ void fetch_row(float* dst, "
                      "const float* src) {\n  for (int k = threadIdx.x; k < WIDTH; k += THREADS) "
                      "dst[k] = src[k];\n}\n")
    src = src.replace(fetched.group(0), "__device__ __forceinline__ void fetched() {}\n")
    assert "asm" not in src, "every inline PTX statement has a stand-in"
    return src.replace('#include "tile_chain.cuh"',
                       '#include "tile_chain.cuh"\nnamespace {\nfloat4 smem4[1 << 16];\n}', 1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel with")
    out = tmp_path_factory.mktemp("biquad_emulated")
    chain = (build.CSRC / "tile_chain.cuh").read_text()
    cut = chain.index("// 32-bit slots of a link")
    (out / "tile_chain.cuh").write_text(chain[:cut] + (HERE / "links.h").read_text())
    shutil.copy(HERE / "cuda_runtime.h", out / "cuda_runtime.h")
    (out / "biquad_scan.cpp").write_text(emulated_source())
    so = out / "libbiquad_emulated.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
                          "-fPIC", "-shared", "-Wno-unknown-pragmas", f"-I{out}", "-o", str(so),
                          str(out / "biquad_scan.cpp"), "-lpthread"],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.biquad_scan.argtypes = build.SIGNATURES["biquad_scan"]["biquad_scan"]
    lib.biquad_scan.restype = ctypes.c_int
    return lib


class Emulated:
    """The wrapper cuda/biquad_scan.sos_apply_df around the emulated
    kernel: one scratch buffer, its block count and epochs carried from
    call to call as cuda/launch.chain carries them."""

    def __init__(self, lib):
        self.lib, self.base, self.epoch = lib, 0, 0
        self.scratch = np.zeros(4 + 8 * 4096, np.int32)

    def __call__(self, tab, state, x):
        n, S = x.shape[0], tab.shape[0]
        cplx = np.iscomplexobj(x)
        rows, rs, cs = (2, 1, 2) if cplx else (1, n, 1)
        tiles = -(-n // kiir.SOS_TILE)
        assert 4 + 8 * S * rows * (tiles + -(-tiles // kiir.SOS_WINDOW)) <= self.scratch.size
        xf = np.ascontiguousarray(x).view(np.float32)
        v0 = np.ascontiguousarray(np.moveaxis(state.view(np.float32).reshape(S, 2, rows), 0, 0))
        y = np.empty_like(xf)
        last = np.empty_like(v0)
        self.epoch += 1
        ptr = lambda a: a.ctypes.data
        assert self.lib.biquad_scan(ptr(tab), ptr(xf), ptr(v0), ptr(y), ptr(last),
                                    ptr(self.scratch), S, rows, n, rs, cs, self.base, self.epoch,
                                    None) == 0
        self.base += rows * tiles
        dt = np.complex64 if cplx else np.float32
        return last.reshape(S, 2 * rows).view(dt).reshape(S, 2), y.view(dt)


def _inputs(n, cplx, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    st = (0.1 * rng.standard_normal((S, 2))).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(n)).astype(np.complex64)
        st = (st + 0.1j * rng.standard_normal((S, 2))).astype(np.complex64)
    return x, st


def _equal_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


_L, _T = kiir.SOS_L, kiir.SOS_TILE


@pytest.mark.parametrize("n", [1, _L + 1, _T + 1, 3 * _T + 147])
@pytest.mark.parametrize("which", ["hard", "dc_block"])
def test_emulated_kernel_equals_plain_version(lib, which, n):
    """One call, complex and real rows, from a random state: the kernel's
    outputs and final states equal the plain version's bit for bit."""
    sos = HARD if which == "hard" else DC_BLOCK
    tab = kiir.sos_table(sos)
    run = Emulated(lib)
    for cplx in (True, False):
        x, st = _inputs(n, cplx, len(sos), seed=n)
        ks, ky = run(tab, st, x)
        rs, ry = kiir.sos_apply_df(torch.from_numpy(tab), torch.from_numpy(st), torch.from_numpy(x))
        assert _equal_bits(ky, ry.numpy()) and _equal_bits(ks, rs.numpy())


def test_emulated_kernel_chained_calls(lib):
    """Three calls carrying the state (the scratch's epochs and block count
    carried too): bit for bit the plain version's."""
    tab = kiir.sos_table(HARD)
    x, st = _inputs(2 * _T + 40, True, len(HARD), seed=3)
    run = Emulated(lib)
    ks, rs = st, torch.from_numpy(st)
    for a, b in ((0, 7), (7, _T + 20), (_T + 20, x.shape[0])):
        ks, ky = run(tab, ks, x[a:b])
        rs, ry = kiir.sos_apply_df(torch.from_numpy(tab), rs, torch.from_numpy(x[a:b]))
        assert _equal_bits(ky, ry.numpy()) and _equal_bits(ks, rs.numpy())
