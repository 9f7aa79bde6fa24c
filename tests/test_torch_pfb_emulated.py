"""csrc/pfb_branch.cu's own source, built with g++ against CPU stand-ins
for the CUDA features it uses (tests/emulate/) and run on the host, held
bit for bit against its plain version (kernels/pfb.branch_accumulate):
complex64, int16 and uint8 input, oversampling 1 and 2, at C = 64 with
blocks of one frame, around the carried tail's length, longer than it,
and a second block fed from the first block's tail.

The stand-ins run a launch's threads one after the other (the kernel's
threads never wait for each other), so this checks the kernel's
arithmetic, its order of operations and its indexing (what the card
checks in chip_smoke.py, bit for bit), not its speed.
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
from tpudsp_torch.kernels import pfb as kpfb

HERE = Path(__file__).resolve().parent / "emulate"
C, T = 64, 8
HTAIL = (T - 1) * C + C - 1
KINDS = {"c64": 0, "i16": 1, "u8": 2}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel with")
    out = tmp_path_factory.mktemp("pfb_emulated")
    src = (build.CSRC / "pfb_branch.cu").read_text()
    src, k = re.subn(r"(\w+)<<<([^,]+), (\w+), .*?>>>\(", r"emulate_serial_launch(\2, \3, \1, ",
                     src)
    assert k == 1, "one launch"
    shutil.copy(HERE / "cuda_runtime.h", out / "cuda_runtime.h")
    (out / "pfb_branch.cpp").write_text(src)
    so = out / "libpfb_emulated.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
                          "-fPIC", "-shared", "-Wno-unknown-pragmas", f"-I{out}", "-o", str(so),
                          str(out / "pfb_branch.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.pfb_branch.argtypes = build.SIGNATURES["pfb_branch"]["pfb_branch"]
    lib.pfb_branch.restype = ctypes.c_int
    return lib


def emulated(lib, Ht, tail, x, os):
    """The wrapper cuda/pfb.branch_accumulate around the emulated kernel."""
    kind = KINDS[{np.complex64: "c64", np.int16: "i16", np.uint8: "u8"}[x.dtype.type]]
    M = x.shape[0] * os // C
    u = np.empty((M, C), np.complex64)
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data
    assert lib.pfb_branch(ptr(Ht), ptr(tail), ptr(x), u.ctypes.data, kind, T, C, os, M,
                          None) == 0
    return u


def _wire(n, fmt, rng):
    if fmt == "c64":
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    if fmt == "i16":
        return rng.integers(-32767, 32768, (n, 2)).astype(np.int16)
    return rng.integers(0, 256, (n, 2)).astype(np.uint8)


def _taps(rng):
    return (rng.standard_normal((T, C)) / (T * C)).astype(np.float32)


def _equal_bits(a, b):
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("n", [C, (T - 1) * C, T * C, (T + 1) * C, 3 * T * C + 5 * C])
@pytest.mark.parametrize("os", [1, 2])
@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_emulated_kernel_equals_plain_version(lib, fmt, os, n):
    """One block of n samples behind a random tail: u bit for bit."""
    rng = np.random.default_rng(n + 7 * os)
    Ht, tail, x = _taps(rng), _wire(HTAIL, fmt, rng), _wire(n, fmt, rng)
    ref = kpfb.branch_accumulate(torch.from_numpy(Ht), torch.from_numpy(tail),
                                 torch.from_numpy(x), os).numpy()
    assert _equal_bits(emulated(lib, Ht, tail, x, os), ref)


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_emulated_kernel_second_block_from_the_first_tail(lib, fmt):
    """Two blocks, the second behind the last HTAIL samples of tail ++
    block 1, at oversampling 2: bit for bit."""
    rng = np.random.default_rng(3)
    Ht = _taps(rng)
    tail = _wire(HTAIL, fmt, rng)
    for n in (2 * C, 9 * C):
        x = _wire(n, fmt, rng)
        ref = kpfb.branch_accumulate(torch.from_numpy(Ht), torch.from_numpy(tail),
                                     torch.from_numpy(x), 2).numpy()
        assert _equal_bits(emulated(lib, Ht, tail, x, 2), ref)
        tail = np.concatenate([tail, x])[-HTAIL:]
