"""Utility ops (port of ``tpudsp/ops/util.py``): ``bytes_to_iq``. Delay and
HilbertTransform are not ported yet; building one raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import numpy as np

from .base import not_ported

_I16_SCALE = np.float32(1.0) / np.float32(32767.0)


def bytes_to_iq(byts: bytes) -> np.ndarray:
    """Raw interleaved int16 IQ bytes -> complex64 scaled by 1/32767
    (reference utility.hpp:61-69). Each value is multiplied by the f32
    reciprocal 1.0f/32767.0f, as the JAX package's native conversion
    (tpudsp/io/native/ingest.cpp) does; trailing bytes that do not complete
    a 4-byte IQ pair are dropped. A host-side numpy conversion: the port
    keeps its own copy and imports nothing of tpudsp.io."""
    n = len(byts) // 4
    x = np.frombuffer(byts, np.int16, count=2 * n).astype(np.float32) * _I16_SCALE
    out = np.empty(n, np.complex64)
    out.real = x[0::2]
    out.imag = x[1::2]
    return out


Delay = not_ported("Delay", "Queue A #7")
HilbertTransform = not_ported("HilbertTransform", "Queue A #7")
