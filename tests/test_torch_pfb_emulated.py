"""csrc/pfb_branch.cu's own source, built with g++ against CPU stand-ins
for the CUDA features it uses (tests/emulate/) and run on the host, held
bit for bit against its plain version (kernels/pfb.branch_accumulate):
complex64, int16 and uint8 input, oversampling 1 and 2, T = 6, 8 and 12
taps a branch (the kernel's instances for up to 8 and 12 taps, the taps
past T masked), at C = 64 and at channel counts that are no multiple of
a warp (a warp's lanes then cross from one run of frames to the next),
with blocks of one frame, around the carried tail's length, longer than
it, blocks cut into runs of frames with a short last run, and a second
block fed from the first block's tail.

The stand-ins run a launch's threads one after the other (the kernel's
threads never wait for each other), so this checks the kernel's
arithmetic, its order of operations and its indexing (what the card
checks in chip_smoke.py, bit for bit), not its speed. The emulated card
has ``emulate_sms`` SMs of one resident block (256 threads) each: the
launch cuts every branch's frames into that many threads' runs (of at
least 32 frames).
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
    src += '\nextern "C" void emulate_sms(int n) { g_sms = n; }\n'
    (out / "pfb_branch.cpp").write_text(src)
    so = out / "libpfb_emulated.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
                          "-fPIC", "-shared", "-Wno-unknown-pragmas", f"-I{out}", "-o", str(so),
                          str(out / "pfb_branch.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.pfb_branch.argtypes = build.SIGNATURES["pfb_branch"]["pfb_branch"]
    lib.pfb_branch.restype = ctypes.c_int
    lib.emulate_sms.argtypes = [ctypes.c_int]
    lib.emulate_sms(1)
    return lib


def emulated(lib, Ht, tail, x, os, sms=1):
    """The wrapper cuda/pfb.branch_accumulate around the emulated kernel, on
    an emulated card of ``sms`` SMs."""
    kind = KINDS[{np.complex64: "c64", np.int16: "i16", np.uint8: "u8"}[x.dtype.type]]
    taps, chans = Ht.shape
    M = x.shape[0] * os // chans
    u = np.full((M, chans), np.nan, np.complex64)
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data
    lib.emulate_sms(sms)
    try:
        assert lib.pfb_branch(ptr(Ht), ptr(tail), ptr(x), u.ctypes.data, kind, taps, chans, os,
                              M, None) == 0
    finally:
        lib.emulate_sms(1)
    return u


def _plain(Ht, tail, x, os):
    return kpfb.branch_accumulate(torch.from_numpy(Ht), torch.from_numpy(tail),
                                  torch.from_numpy(x), os).numpy()


def _wire(n, fmt, rng):
    if fmt == "c64":
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    if fmt == "i16":
        return rng.integers(-32767, 32768, (n, 2)).astype(np.int16)
    return rng.integers(0, 256, (n, 2)).astype(np.uint8)


def _taps(rng, taps=T, chans=C):
    return (rng.standard_normal((taps, chans)) / (taps * chans)).astype(np.float32)


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


# (C, frames of C samples, oversampling): 2x oversampling needs an even C
_SHAPES = [(64, 1, 1), (64, 11, 1), (64, 40, 1), (64, 1, 2), (64, 11, 2), (64, 40, 2),
           (20, 1, 1), (20, 37, 1), (20, 1, 2), (20, 37, 2), (33, 9, 1), (33, 14, 1)]


@pytest.mark.parametrize("chans,n_frames,os", _SHAPES)
@pytest.mark.parametrize("taps", [6, 8, 12])
@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_emulated_kernel_taps_and_channels(lib, fmt, taps, chans, n_frames, os):
    """T = 6, 8 and 12 taps a branch at C = 64 and at C = 20 and 33 (no
    multiple of a warp; 33 at os = 1 only), a block of n_frames frames
    of C samples behind a random tail (fewer than the tail's T frames,
    about it, more): u bit for bit."""
    rng = np.random.default_rng(100 * taps + 10 * os + n_frames)
    htail = taps * chans - 1
    Ht = _taps(rng, taps, chans)
    tail, x = _wire(htail, fmt, rng), _wire(n_frames * chans, fmt, rng)
    assert _equal_bits(emulated(lib, Ht, tail, x, os), _plain(Ht, tail, x, os))


@pytest.mark.parametrize("sms", [1, 2, 5, 64])
@pytest.mark.parametrize("os", [1, 2])
@pytest.mark.parametrize("fmt", ["c64", "u8"])
def test_emulated_kernel_runs_of_frames(lib, fmt, os, sms):
    """A block of 211 frames (422 at os = 2) at T = 12 on emulated cards of
    1 to 64 SMs: each branch's frames cut into 1 to 7 (14) runs of 31 to
    211 (422) frames, the last one short, each run filling its window from
    the samples before its first frame; u bit for bit, every output
    written."""
    rng = np.random.default_rng(sms + 7 * os)
    taps, chans = 12, 64
    Ht = _taps(rng, taps, chans)
    tail, x = _wire(taps * chans - 1, fmt, rng), _wire(211 * chans, fmt, rng)
    assert _equal_bits(emulated(lib, Ht, tail, x, os, sms), _plain(Ht, tail, x, os))


@pytest.mark.parametrize("taps", [6, 12])
@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_emulated_kernel_second_block_at_other_taps(lib, fmt, taps):
    """Two blocks at C = 20, os = 2, the second behind the last samples of
    tail ++ block 1: bit for bit."""
    rng = np.random.default_rng(taps)
    chans = 20
    htail = taps * chans - 1
    Ht = _taps(rng, taps, chans)
    tail = _wire(htail, fmt, rng)
    for n in (3 * chans, 17 * chans):
        x = _wire(n, fmt, rng)
        assert _equal_bits(emulated(lib, Ht, tail, x, 2, sms=3), _plain(Ht, tail, x, 2))
        tail = np.concatenate([tail, x])[-htail:]
