"""IQ ingest (port of ``tpudsp/io/ingest.py``): byte conversion and the
streaming block framing.

Native-backed: ctypes over ``io/native/ingest.cpp``, the port's own copy
of the JAX package's source, compiled by g++ at first use into
``tpudsp_torch/_build/libingest.so`` (under a temporary name, then
``os.replace``: two processes that build it at once each load a whole
library). A host without g++ takes the pure-NumPy fallback, with the JAX
package's fallback semantics. The ring-buffer path is the streaming
runtime the reference's README pattern implies but leaves to user code
(README.md:53-58): a radio driver thread pushes raw bytes; the consumer
pops fixed-size blocks for the receiver chains.

``frame`` is the same conversion in PyTorch, on a block's bytes on any
device: ``io.stream.StreamRuntime`` copies raw wire bytes to the card and
converts them there.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..cuda.build import BUILD

_SRC = Path(__file__).resolve().parent / "native" / "ingest.cpp"
_SO = BUILD / "libingest.so"
SAMPLE_FORMATS = ("int16", "uint8", "int16_raw", "uint8_raw")
# the native code's scales: the f32 reciprocals of 32767 and 127.5
_I16 = float(np.float32(1.0) / np.float32(32767.0))
_U8 = float(np.float32(1.0) / np.float32(127.5))

_lib = None
_lib_lock = threading.Lock()


def _compile() -> Path:
    """Build io/native/ingest.cpp into _build/libingest.so unless it is
    current."""
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    BUILD.mkdir(exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
                    "-o", str(tmp)], check=True, capture_output=True)
    os.replace(tmp, _SO)
    return _SO


def _load():
    """The native library, built and loaded at first use; False on a host
    where it cannot be built (no g++): the NumPy fallback."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_compile()))
        except (OSError, subprocess.CalledProcessError):
            _lib = False
            return _lib
        lib.tpudsp_ring_create.restype = ctypes.c_void_p
        lib.tpudsp_ring_create.argtypes = [ctypes.c_uint64]
        lib.tpudsp_ring_destroy.restype = None
        lib.tpudsp_ring_destroy.argtypes = [ctypes.c_void_p]
        for f in ("tpudsp_ring_size", "tpudsp_ring_capacity", "tpudsp_ring_dropped"):
            getattr(lib, f).restype = ctypes.c_uint64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.tpudsp_ring_write.restype = ctypes.c_uint64
        lib.tpudsp_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.tpudsp_ring_read.restype = ctypes.c_uint64
        lib.tpudsp_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        for f in ("tpudsp_bytes_to_iq_f32", "tpudsp_u8_to_iq_f32"):
            getattr(lib, f).restype = None
            getattr(lib, f).argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
        _lib = lib
    return _lib


def bytes_to_iq(byts) -> np.ndarray:
    """int16 interleaved IQ bytes -> complex64 / 32767 (reference
    utility.hpp:61-69 semantics): each value times the f32 reciprocal of
    32767 in the native code; trailing bytes that do not complete a 4-byte
    pair are dropped."""
    n = len(byts) // 4
    lib = _load()
    out = np.empty(n, np.complex64)
    if lib:
        buf = np.frombuffer(byts, np.uint8, count=4 * n)
        lib.tpudsp_bytes_to_iq_f32(buf.ctypes.data, n, out.ctypes.data)
        return out
    x = np.frombuffer(byts, np.int16, count=2 * n).astype(np.float32) / 32767.0
    return (x[0::2] + 1j * x[1::2]).astype(np.complex64)


def u8_to_iq(byts) -> np.ndarray:
    """RTL-SDR-style uint8 interleaved IQ -> complex64 ((b-127.5)/127.5)."""
    n = len(byts) // 2
    lib = _load()
    out = np.empty(n, np.complex64)
    if lib:
        buf = np.frombuffer(byts, np.uint8, count=2 * n)
        lib.tpudsp_u8_to_iq_f32(buf.ctypes.data, n, out.ctypes.data)
        return out
    x = (np.frombuffer(byts, np.uint8, count=2 * n).astype(np.float32) - 127.5) / 127.5
    return (x[0::2] + 1j * x[1::2]).astype(np.complex64)


def frame(raw: torch.Tensor, sample_format: str) -> torch.Tensor:
    """One block's wire bytes (a 1-D uint8 tensor on any device) -> the
    block a receiver takes, on the same device: the (N, 2) int16 / uint8
    wire samples for 'int16_raw' / 'uint8_raw', and for 'int16' / 'uint8'
    complex64 converted as the native code converts (a value times the f32
    reciprocal of 32767, or less 127.5 and times that of 127.5): the same
    bits as ``bytes_to_iq`` / ``u8_to_iq`` with the native library."""
    if sample_format == "int16_raw":
        return raw.view(torch.int16).view(-1, 2)
    if sample_format == "uint8_raw":
        return raw.view(-1, 2)
    if sample_format == "int16":
        x = raw.view(torch.int16).to(torch.float32) * _I16
    else:
        x = (raw.to(torch.float32) - 127.5) * _U8
    return torch.view_as_complex(x.view(-1, 2))


class IQStream:
    """Lock-free SPSC stream of IQ blocks.

    push(bytes) from the radio-driver thread; pop_block() from the compute
    thread returns one block as a writable numpy array, or None when not
    enough data has arrived; pop_into(buf) copies one block's raw bytes
    into a caller's buffer (the runtime's pinned host slots). Overflow
    drops whole writes (counted in .dropped).
    """

    def __init__(self, block_len: int, capacity_blocks: int = 64,
                 sample_format: str = "int16"):
        """sample_format: 'int16' (convert to complex64/32767, reference
        utility.hpp:61-69), 'uint8' (RTL-SDR style), or the raw
        passthrough twins 'int16_raw' / 'uint8_raw' (no host conversion:
        pop_block returns the (N, 2) wire samples for chains built with
        input_format='i16' / 'u8')."""
        if sample_format not in SAMPLE_FORMATS:
            raise ValueError(f"unknown sample_format {sample_format!r}")
        self.block_len = int(block_len)
        self.sample_format = sample_format
        self._bps = 2 if sample_format.startswith("uint8") else 4
        self.block_bytes = self.block_len * self._bps
        lib = _load()
        self._native = bool(lib)
        if self._native:
            self._lib = lib
            self._ring = lib.tpudsp_ring_create(self.block_bytes * capacity_blocks)
        else:
            self._buf = bytearray()
            self._lock = threading.Lock()
            self._dropped = 0
            self._cap = self.block_bytes * capacity_blocks

    def push(self, byts: bytes) -> int:
        if self._native:
            return self._lib.tpudsp_ring_write(self._ring, byts, len(byts))
        with self._lock:
            if len(self._buf) + len(byts) > self._cap:
                self._dropped += len(byts)
                return 0
            self._buf.extend(byts)
            return len(byts)

    def pop_into(self, buf: np.ndarray) -> bool:
        """Copy the next block's raw bytes into ``buf`` (a contiguous uint8
        array of ``block_bytes``, which may view pinned memory); False, and
        nothing copied, when the ring holds less than a block."""
        if buf.dtype != np.uint8 or buf.shape != (self.block_bytes,) or not buf.flags.c_contiguous:
            raise ValueError(f"pop_into needs a contiguous uint8 buffer of "
                             f"{self.block_bytes} bytes")
        if self._native:
            return bool(self._lib.tpudsp_ring_read(self._ring, buf.ctypes.data,
                                                   self.block_bytes))
        with self._lock:
            if len(self._buf) < self.block_bytes:
                return False
            buf[:] = np.frombuffer(self._buf, np.uint8, count=self.block_bytes)
            del self._buf[:self.block_bytes]
        return True

    def pop_block(self):
        raw = np.empty(self.block_bytes, np.uint8)
        if not self.pop_into(raw):
            return None
        if self.sample_format == "int16_raw":
            return raw.view(np.int16).reshape(-1, 2)
        if self.sample_format == "uint8_raw":
            return raw.reshape(-1, 2)
        conv = bytes_to_iq if self.sample_format == "int16" else u8_to_iq
        return conv(raw)

    @property
    def pending_bytes(self) -> int:
        if self._native:
            return self._lib.tpudsp_ring_size(self._ring)
        with self._lock:
            return len(self._buf)

    @property
    def dropped(self) -> int:
        if self._native:
            return self._lib.tpudsp_ring_dropped(self._ring)
        return self._dropped

    def __del__(self):
        if getattr(self, "_native", False):
            self._lib.tpudsp_ring_destroy(self._ring)
