"""csrc/am_front_scan.cu's two instances, its own source built with g++
against CPU stand-ins for the CUDA features it uses (tests/emulate/) and
run on the host: the matrix instance (``am_front_scan_mc``: the streams
read in place as the columns of a (L, C) complex64 matrix, lane i*C + c,
vr and modes written as (C, L) rows out of the stage buffers) held bit for
bit against the planes instance (``am_front_scan``: (chunk, lanes) planes,
lane c*nchunks + i) on the same streams, through the wrappers' own
launches (``cuda/am_backend_scan._front_mc`` and the planes route of
``front_chunked``), and both near the plain version. Shapes: a padded last
chunk with its exact re-run, a warmup longer than a chunk, a chunk the
stage depth (64) does not divide, channel counts that are and are not a
multiple of the 32 lanes a block takes, the exact route (one chunk), and
PLL states that take the unbounded PLL path.

The stand-ins run a launch's blocks one after the other, each block's
threads at once (barriers, warp votes emulated), so this checks the
kernel's staging, indexing and write-out, not its timing. The host's
sincosf is not the card's: the emulated source takes the card's
branch-free sincosf path (``sin_cos_reduced``, exact there for |x| <
105615) in the unbounded PLL step too, so the instances agree wherever
their warps vote differently, as they do on the card.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.util import snr_db
from tpudsp_torch.cuda import am_backend_scan as scan
from tpudsp_torch.cuda import build, launch
from tpudsp_torch.kernels import agc as kagc
from tpudsp_torch.kernels import am_backend as kab
from tpudsp_torch.kernels import lanes
from tpudsp_torch.kernels.pll import PllState

HERE = Path(__file__).resolve().parent / "emulate"

# the inline PTX helpers of csrc/scan_step.cuh, and what they do
PLAIN = {
    r"void cp_async4\(float\* dst, const float\* src, bool valid\) \{":
        "void cp_async4(float* dst, const float* src, bool valid) {\n"
        "  *dst = valid ? *src : 0.0f;\n}\n",
    r"void cp_async_wait_all\(\) \{": "void cp_async_wait_all() {}\n",
    r"void store_if\(bool c, float\* p, float v\) \{":
        "void store_if(bool c, float* p, float v) {\n  if (c) *p = v;\n}\n",
    r"void store_if\(bool c, int\* p, int v\) \{":
        "void store_if(bool c, int* p, int v) {\n  if (c) *p = v;\n}\n",
}


def emulated_sources(out: Path):
    """scan_step.cuh and am_front_scan.cu rewritten for the stand-ins, into
    ``out``."""
    head = (build.CSRC / "scan_step.cuh").read_text()
    for sig, plain in PLAIN.items():
        head, k = re.subn(sig + r".*?\n\}\n", plain, head, count=1, flags=re.S)
        assert k == 1, sig
    assert "asm" not in head, "every inline PTX statement has a stand-in"
    (out / "scan_step.cuh").write_text(head.replace("__noinline__", ""))
    src = (build.CSRC / "am_front_scan.cu").read_text()
    src, k = re.subn(r"(\w+<\w+>)<<<([^,]+), ([^,]+), .*?>>>\(", r"emulate_launch(\2, \3, \1, ",
                     src, flags=re.S)
    assert k == 1, "one launch"
    src, k = re.subn(r"sincosf\(theta, &s, &c\);", "sin_cos_reduced(theta, s, c);", src)
    assert k == 1, "the unbounded PLL step's sincosf"
    src = src.replace('#include "scan_step.cuh"',
                      '#include "scan_step.cuh"\nnamespace {\nalignas(16) float smem[1 << 16];\n}',
                      1)
    (out / "am_front_scan.cpp").write_text(src)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel with")
    out = tmp_path_factory.mktemp("am_front_emulated")
    shutil.copy(HERE / "cuda_runtime.h", out / "cuda_runtime.h")
    emulated_sources(out)
    so = out / "libam_front_emulated.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
                          "-fPIC", "-shared", "-Wno-unknown-pragmas", f"-I{out}", "-o", str(so),
                          str(out / "am_front_scan.cpp"), "-lpthread"],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for name, argtypes in build.SIGNATURES["am_front_scan"].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture
def on_host(lib, monkeypatch):
    """The wrappers' launches, of CPU tensors, into the emulated library."""
    def run(kernel, device, *args, source=None, on=None):
        ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
        assert getattr(lib, kernel)(*ptrs, None) == 0
    monkeypatch.setattr(launch, "on_cuda", lambda kernel, device: None)
    monkeypatch.setattr(launch, "launch", run)


def _params():
    return kab.make_params(kagc.make_params(alpha=0.05, scale=1.0, device="cpu"), 1.0,
                           0.1, 0.9, carrier=True)


def _state(C, seed, theta=0.5):
    g = torch.Generator().manual_seed(seed)
    agc = kagc.AgcState(*(v.expand(C).contiguous() for v in kagc.agc_init(device="cpu")))
    th = (torch.rand(C, generator=g) * 2 - 1) * theta
    return kab.FrontState(agc, PllState(th, (torch.rand(C, generator=g) - 0.5) * 0.02))


def _matrix(L, C, seed):
    """C AM carriers a little off centre, one per column, in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)[:, None]
    f = rng.uniform(-0.002, 0.002, C)
    m = 1 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.005, 0.02, C) * t)
    y = 0.3 * m * np.exp(2j * np.pi * f * t) + 0.01 * (rng.standard_normal((L, C))
                                                       + 1j * rng.standard_normal((L, C)))
    return torch.from_numpy(y.astype(np.complex64))


def _planes_route(p, st, x, chunk, warmup):
    """front_chunked's launches on CUDA: the planes, the chunked launch, and
    a padded last chunk's exact re-run."""
    C, L = x.shape
    if L <= chunk + warmup:
        xre, xim, _, _ = lanes.planes(x, L)
        vr, modes, fin = scan._launch(p, st, xre, xim, 1, 0)
        return fin, (vr.T, modes.T)
    xre, xim, nchunks, pad = lanes.planes(x, chunk)
    vr, modes, fin = scan._launch(p, st, xre, xim, nchunks, warmup)
    front = lanes.per_stream(fin, C, -1)
    if pad:
        tail = x[:, (nchunks - 1) * chunk:].contiguous()
        tre, tim, _, _ = lanes.planes(tail, tail.shape[1])
        _, _, front = scan._launch(p, lanes.per_stream(fin, C, -2), tre, tim, 1, 0)
    return front, (lanes.unplanes(vr, C, L), lanes.unplanes(modes, C, L))


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _leaves(front, outs):
    return [*front.agc, *front.pll, *outs]


@pytest.mark.parametrize("L, C, chunk, warmup, theta", [
    # chunk 300 (no multiple of 64), warmup 350 (a chunk and a sixth), 40
    # channels (8 lanes of a block past a whole group), a padded last chunk
    (1000, 40, 300, 350, 0.5),
    # no padded chunk, 64 channels (two groups a chunk), warmup under a stage
    (1024, 64, 256, 48, 0.5),
    # one chunk: the exact route, 33 channels
    (700, 33, 500, 300, 0.5),
    # PLL states outside [-pi, pi]: some warps take the unbounded PLL step
    (640, 35, 200, 150, 9.0),
])
def test_matrix_instance_equals_planes_instance(on_host, L, C, chunk, warmup, theta):
    p, st, Y = _params(), _state(C, L + C, theta), _matrix(L, C, L * C)
    launches, matrix = scan._launch.launches, scan._launch.matrix
    front, (vr, modes) = scan._front_mc(p, st, Y, chunk, warmup)
    padded = L > chunk + warmup and L % chunk
    assert scan._launch.matrix - matrix == (2 if padded else 1)
    assert vr.shape == modes.shape == (C, L) and vr.is_contiguous() and modes.is_contiguous()
    assert vr.dtype == torch.float32 and modes.dtype == torch.int32
    if L > chunk + warmup and not padded:   # the carried state: a view of the lanes'
        assert front.agc.g._base is not None and front.agc.g.is_contiguous()
    want = _planes_route(p, st, Y.T.contiguous(), chunk, warmup)
    assert scan._launch.launches - launches == 2 * (scan._launch.matrix - matrix)
    for got, ref in zip(_leaves(front, (vr, modes)), _leaves(*want)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert torch.equal(_bits(got), _bits(ref))
    # the host's expf / logf / log10f are not the plain version's exactly
    plain = scan.front_chunked_mc_ref(p, st, Y, chunk, warmup)
    assert snr_db(plain[1][0].numpy(), vr.numpy()) >= 100.0


def test_matrix_instance_writes_no_rows_when_asked_for_none(on_host):
    """The exact re-run of a padded last chunk passes no rows: it writes
    only its states."""
    p, C, L = _params(), 40, 224
    Y = _matrix(L, C, 7)
    st = _state(C, 3)
    vr, modes, fin = scan._launch_mc(scan._scalars(p), st, Y, L, 0, outputs=False)
    assert vr is None and modes is None
    _, _, ref = scan._launch_mc(scan._scalars(p), st, Y, L, 0)
    for a, b in zip(_leaves(fin, ()), _leaves(ref, ())):
        assert torch.equal(_bits(a), _bits(b))
