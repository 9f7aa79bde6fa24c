"""Utility ops (port of ``tpudsp/ops/util.py``): Delay, HilbertTransform
and ``bytes_to_iq``."""

from __future__ import annotations

import numpy as np
import torch

from ..design import firdes
from ..kernels import fir as kfir
from ..kernels import hilbert as khilb
from .base import StatefulOp, resolve_device, to_numpy


def bytes_to_iq(byts: bytes) -> np.ndarray:
    """Raw interleaved int16 IQ bytes -> complex64 scaled by 1/32767
    (reference utility.hpp:61-69). Delegates to the port's native-backed
    conversion in ``io/ingest.py``, as the JAX package's op does: each
    value times the f32 reciprocal 1.0f/32767.0f; trailing bytes that do
    not complete a 4-byte IQ pair are dropped."""
    from ..io.ingest import bytes_to_iq as _impl
    return _impl(byts)


def _as_1d(inp, name: str, device):
    """A 1-D complex64 or float32 numpy array or tensor -> a tensor on
    ``device`` of that dtype; anything else raises TypeError, as the JAX
    ops do (the reference silently returns None)."""
    if torch.is_tensor(inp):
        x, dtypes = inp, (torch.complex64, torch.float32)
    else:
        x, dtypes = np.asarray(inp), (np.complex64, np.float32)
    if x.ndim != 1:
        raise TypeError(f"{name}: expected 1-D array, got shape {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: expected complex64 or float32 input, got {x.dtype}")
    return x.to(device) if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x)).to(device)


class Delay(StatefulOp):
    """Fixed N-sample delay line: Delay(nd=1). complex64 and float32 inputs
    use independent delay lines, like the reference's twin wdelayf /
    wdelaycf handles. Setting ``delay`` recreates the lines, clearing
    state. Other dtypes raise TypeError."""

    def __init__(self, nd=1, *, device=None):
        self._device = resolve_device(device)
        self._nd = int(nd)
        self.reset()

    def reset(self):
        self._state = {
            "real": kfir.delay_init(self._nd, torch.float32, self._device),
            "complex": kfir.delay_init(self._nd, torch.complex64, self._device),
        }

    @property
    def delay(self):
        return self._nd

    @delay.setter
    def delay(self, nd):
        self._nd = int(nd)
        self.reset()   # the reference recreates its handles, clearing state

    def __call__(self, inp):
        x = _as_1d(inp, "Delay", self._device)
        line = "complex" if x.is_complex() else "real"
        self._state[line], y = kfir.delay_apply(self._state[line], x)
        return to_numpy(y)


class HilbertTransform(StatefulOp):
    """Real <-> complex conversion by a half-band FIR Hilbert transform:
    HilbertTransform(m=5, As=60). complex64 input -> interp -> float32 at
    twice the rate (2N samples); float32 input (even length) -> decim ->
    complex64 at half the rate (N/2 samples). Other dtypes raise
    TypeError; an odd-length float32 block raises ValueError."""

    def __init__(self, m=5, As=60.0, *, device=None):
        self._device = resolve_device(device)
        self._m = int(m)
        self._h = torch.tensor(firdes.halfband_lowpass(self._m, As).astype(np.float32),
                               device=self._device)
        self.reset()

    def reset(self):
        self._state = {
            "interp": khilb.interp_init(self._m, self._device),
            "decim": khilb.decim_init(self._m, self._device),
        }

    def __call__(self, inp):
        x = _as_1d(inp, "HilbertTransform", self._device)
        if x.is_complex():
            self._state["interp"], y = khilb.interp_apply(self._h, self._state["interp"], x)
            return to_numpy(y)
        if x.shape[0] % 2:
            raise ValueError("HilbertTransform: decimating path needs even length")
        self._state["decim"], y = khilb.decim_apply(self._h, self._state["decim"], x)
        return to_numpy(y)
