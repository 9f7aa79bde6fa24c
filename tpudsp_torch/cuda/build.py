"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` (no PyTorch headers, so a build takes seconds) into
``tpudsp_torch/_build/lib<name>.so``, which ``.gitignore`` lists:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

``-fmad=false`` keeps every multiply and add rounded on its own, as the
plain PyTorch versions round them; there is no ``--use_fast_math``.
A library is rebuilt when its source, or any header in ``csrc/`` (the
sources share ``scan_step.cuh``, ``tile_chain.cuh`` and
``fm_discriminator.cuh``), is newer than it. ptxas's report of each
kernel's registers, shared memory and spills (``-Xptxas -v``) is kept
beside the library as ``_build/lib<name>.ptxas.txt``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point, by source name
SIGNATURES = {
    "am_front_scan": {
        "am_front_scan": [_P] * 17 + [_I] * 4 + [_P],
        "am_front_scan_mc": [_P] * 16 + [_I] * 5 + [_P],
    },
    "agc_scan": {
        "agc_scan": [_P] * 14 + [_I] * 4 + [_P],
    },
    "pll_scan": {
        "pll_scan": [_P] * 8 + [_I] * 4 + [_P],
    },
    "halo_async": {
        "halo_async": [_P] * 4 + [_I] * 10 + [_P],
    },
    "first_order_scan": {
        "first_order_scan": [_P] * 6 + [_I] * 6 + [_P],
        "linear_tail_scan": [_P] * 10 + [_I] * 4 + [_P],
        "first_order_scan_cols": [_P] * 5 + [_I] * 2 + [_P],
        "fm_deemph_cols": [_P] * 3 + [_F] + [_P] * 4 + [_I] * 2 + [_P],
    },
    "biquad_scan": {
        "biquad_scan": [_P] * 6 + [_I] * 7 + [_P],
    },
    "pfb_branch": {
        "pfb_branch": [_P] * 4 + [_I] * 5 + [_P],
    },
    "bank_rotate": {
        "bank_rotate": [_P] * 7 + [_I] * 3 + [_F] * 2 + [_P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def compile_source(name: str) -> Path:
    """Compile csrc/<name>.cu into _build/lib<name>.so unless it is current.
    Returns the library's path; raises with nvcc's output on failure."""
    src = CSRC / f"{name}.cu"
    out = BUILD / f"lib{name}.so"
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(command(src, tmp), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{res.stderr}")
    ptxas_report_path(name).write_text(res.stderr)
    os.replace(tmp, out)
    return out


def command(src: Path, out: Path) -> list[str]:
    """The nvcc command that builds the source ``src`` into ``out``."""
    return [nvcc(), ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(src)]


def ptxas_report_path(name: str) -> Path:
    """Where ``compile_source`` keeps ptxas's report for csrc/<name>.cu."""
    return BUILD / f"lib{name}.ptxas.txt"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use, with
    argtypes and restype set for each of its entry points."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
