"""csrc/first_order_scan.cu's column entry (first_order_scan_cols), its
own source built with g++ against CPU stand-ins for the CUDA features it
uses (tests/emulate/) and run on the host, held bit for bit against its
plain version (kernels/iir.first_order_apply_blocked_mc): outputs and last
values from random carries, at N = 1, 31, 33, one tile less one, one
tile, one tile and one, two tiles and one (a tile is COLS_TILE_BLOCKS
blocks of 32 samples), at channel counts that are and are not a multiple
of the 8 a block takes, with infinite and NaN samples, and over chained
calls.

The stand-ins run a launch's blocks one after the other, each block's
threads at once (barriers and warp shuffles emulated), so this checks the
kernel's arithmetic, its order of operations, its staging and its
indexing (what the card checks in chip_smoke.py, bit for bit), not its
timing: the cp.async copies are plain there.
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
TILE = kiir.COLS_TILE_BLOCKS * kiir.L_BLOCK
DEEMPH = iirdes.deemphasis_coeffs(16_384.0 * 6.103515625)   # config 4's channel rate
DC = (1.0 - 0.9995, 0.9995)                                  # a near-unit pole


# the kernel's cp.async helpers, and what they do, as plain copies
PLAIN_COPIES = {
    r"void copy4\(float\* dst, const float\* src, bool in\) \{":
        "void copy4(float* dst, const float* src, bool in) {\n  *dst = in ? *src : 0.0f;\n}\n",
    r"void copies_commit\(\) \{": "void copies_commit() {}\n",
    r"void copies_wait\(\) \{": "void copies_wait() {}\n",
}


def emulated_source() -> str:
    """first_order_scan.cu with its launches, its cp.async copies and its
    shared memory rewritten for the stand-ins."""
    src = (build.CSRC / "first_order_scan.cu").read_text()
    src, k = re.subn(r"(\w+)<<<([^,]+), (\w+), .*?>>>\(", r"emulate_launch(\2, \3, \1, ", src,
                     flags=re.S)
    assert k == 3, "three launches"
    for head, plain in PLAIN_COPIES.items():
        src, k = re.subn(head + r".*?\n\}\n", plain.replace("\\", "\\\\"), src, count=1,
                         flags=re.S)
        assert k == 1, head
    assert "asm" not in src, "every inline PTX statement has a stand-in"
    return src.replace('#include "tile_chain.cuh"',
                       '#include "tile_chain.cuh"\nnamespace {\nfloat4 smem4[1 << 16];\n}', 1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel with")
    out = tmp_path_factory.mktemp("first_order_cols_emulated")
    chain = (build.CSRC / "tile_chain.cuh").read_text()
    cut = chain.index("// 32-bit slots of a link")
    (out / "tile_chain.cuh").write_text(chain[:cut] + (HERE / "links.h").read_text())
    shutil.copy(HERE / "cuda_runtime.h", out / "cuda_runtime.h")
    (out / "first_order_scan.cpp").write_text(emulated_source())
    so = out / "libfirst_order_emulated.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
                          "-fPIC", "-shared", "-Wno-unknown-pragmas", f"-I{out}", "-o", str(so),
                          str(out / "first_order_scan.cpp"), "-lpthread"],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    fn = lib.first_order_scan_cols
    fn.argtypes = build.SIGNATURES["first_order_scan"]["first_order_scan_cols"]
    fn.restype = ctypes.c_int
    return lib


def emulated(lib, b0, a, y_prev, x):
    """The wrapper cuda/first_order.first_order_apply_blocked_mc around the
    emulated kernel."""
    n, C = x.shape
    tab = kiir.block_table(b0, a)
    x = np.ascontiguousarray(x, np.float32)
    y0 = np.ascontiguousarray(y_prev, np.float32)
    y = np.full((C, n), np.nan, np.float32)
    last = np.full(C, np.nan, np.float32)
    ptr = lambda v: v.ctypes.data
    assert lib.first_order_scan_cols(ptr(tab), ptr(x), ptr(y0), ptr(y), ptr(last), C, n,
                                     None) == 0
    return last, y.T


def _plain(b0, a, y_prev, x):
    last, y = kiir.first_order_apply_blocked_mc(b0, a, torch.from_numpy(y_prev),
                                                torch.from_numpy(x))
    return last.numpy(), y.numpy()


def _inputs(n, C, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, C)) + np.linspace(-1, 1, C)).astype(np.float32)
    return x, rng.standard_normal(C).astype(np.float32)


def _equal_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_table_is_lower_triangular_toeplitz():
    """The column entry takes T[i, j] = T[i - j, 0] for j <= i and 0 above
    the diagonal (its products from T's first column): so block_table
    makes it, at both designs."""
    for b0, a in (DEEMPH, DC):
        T = kiir.block_table(b0, a)[:kiir.L_BLOCK ** 2].reshape(kiir.L_BLOCK, kiir.L_BLOCK)
        i, j = np.indices(T.shape)
        assert np.array_equal(T.view(np.uint32),
                              np.where(j <= i, T[np.maximum(i - j, 0), 0], 0.0).astype(
                                  np.float32).view(np.uint32))


@pytest.mark.parametrize("n", [1, 31, 33, TILE - 1, TILE, TILE + 1, 2 * TILE + 1])
@pytest.mark.parametrize("C", [4, 6])
@pytest.mark.parametrize("coeffs", ["deemph", "dc"])
def test_emulated_kernel_equals_plain_version(lib, coeffs, C, n):
    """One call from random carries: the (C, N) rows and the last values
    equal the plain version's bit for bit (C = 4 and 6: one partial group
    of 8 channels)."""
    b0, a = DEEMPH if coeffs == "deemph" else DC
    x, y0 = _inputs(n, C, seed=n + C)
    k_last, k_y = emulated(lib, b0, a, y0, x)
    r_last, r_y = _plain(b0, a, y0, x)
    assert _equal_bits(k_y, r_y) and _equal_bits(k_last, r_last)


@pytest.mark.parametrize("C", [1, 5, 9, 16, 20, 36])
def test_emulated_kernel_channel_counts(lib, C):
    """C = 1 to 36 (one to five groups of 8, the last full or partial) over
    two tiles and a ragged block: bit for bit."""
    x, y0 = _inputs(TILE + 45, C, seed=C)
    k_last, k_y = emulated(lib, *DEEMPH, y0, x)
    r_last, r_y = _plain(*DEEMPH, y0, x)
    assert _equal_bits(k_y, r_y) and _equal_bits(k_last, r_last)


@pytest.mark.parametrize("C", [8, 6])
def test_emulated_kernel_non_finite_samples(lib, C):
    """Infinite and NaN samples in a few blocks (the prefix's products of
    the zeros above T's diagonal are then added, as the plain version adds
    them): every output and last value bit for bit, NaNs included."""
    x, y0 = _inputs(2 * TILE + 3, C, seed=11)
    x[40, 1], x[37, 2], x[TILE + 70, 0] = np.inf, -np.inf, np.nan
    x[2 * TILE, C - 1] = np.nan
    k_last, k_y = emulated(lib, *DC, y0, x)
    r_last, r_y = _plain(*DC, y0, x)
    assert np.isnan(r_y).any() and np.isfinite(r_y[:, 3]).all()
    assert _equal_bits(k_y, r_y) and _equal_bits(k_last, r_last)


def test_emulated_kernel_chained_calls(lib):
    """Three calls carrying the last values, over lengths that end inside a
    tile: bit for bit the plain version's."""
    x, y0 = _inputs(3 * TILE + 100, 6, seed=3)
    k_prev, r_prev = y0, y0
    for lo, hi in ((0, TILE + 5), (TILE + 5, TILE + 6), (TILE + 6, x.shape[0])):
        k_prev, k_y = emulated(lib, *DEEMPH, k_prev, x[lo:hi])
        r_prev, r_y = _plain(*DEEMPH, r_prev, np.ascontiguousarray(x[lo:hi]))
        assert _equal_bits(k_y, r_y) and _equal_bits(k_prev, r_prev)
