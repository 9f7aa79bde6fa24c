"""IIR / FIR filter op classes (port of ``tpudsp/ops/filters.py``).

Mirrors: CIIRFilter, CLowpassIIR, CHighpassIIR, CBandpassIIR, CBandstopIIR,
RIIRFilter, RLowpassIIR, RHighpassIIR, RBandpassIIR, RBandstopIIR,
ComplexIIRFilter, RealIIRFilter, DeemphasisFilter, RealFIRFilter,
RealDCBlocker, RealKaiserBessel.

LTI IIR filters run as their truncated impulse response (TIR) through
``kernels/fir.fir_apply`` -- the JAX package's default mode. The recurrence
mode (``mode="scan"``, and an ``"auto"`` design whose impulse response does
not decay within TIR_MAX_TAPS taps) runs the double-float SOS cascade
``cuda/biquad_scan.sos_apply_df``: one launch of the CUDA kernel
``csrc/biquad_scan.cu`` a call on the card, its plain version on the CPU.

DeemphasisFilter: the JAX op runs the plain f32 associative scan
``first_order_apply`` with f32-rounded coefficients; the port runs its
blocked scan with a double-float carry on the float64 design values
(``cuda/first_order.first_order_apply_blocked``: one launch of the CUDA
kernel ``csrc/first_order_scan.cu`` a call on the card). The two agree
to within f32 rounding at a = 0.757 (48 kHz), far from the unit circle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..design import firdes, iirdes
from ..cuda import biquad_scan, first_order
from ..kernels import fir as kfir
from ..kernels import iir as kiir
from .base import StatefulOp, as_c64, as_f32, resolve_device, to_numpy

# truncated-IR execution is used when the impulse response fits in this many
# taps, as in the JAX package
TIR_MAX_TAPS = 65536


def _f32(v, device):
    return torch.tensor(np.asarray(v, np.float32), device=device)


class _SosFilterBase(StatefulOp):
    """Shared engine for all LTI IIR ops."""

    def __init__(self, sos: np.ndarray, complex_data: bool, mode: str = "auto",
                 *, device=None):
        self._device = resolve_device(device)
        self._sos = np.asarray(sos, dtype=np.float64)
        self._complex = complex_data
        self._dtype = torch.complex64 if complex_data else torch.float32
        self._tir_taps = None
        if mode in ("auto", "tir"):
            h = iirdes.sos_impulse_response(self._sos, max_len=TIR_MAX_TAPS)
            if h is not None:
                self._tir_taps = _f32(h, self._device)
        if mode == "tir" and self._tir_taps is None:
            raise ValueError("impulse response does not decay within TIR budget")
        # the recurrence runs the double-float cascade on the float64 design
        self._sos_table = None if self._tir_taps is not None else torch.from_numpy(
            kiir.sos_table(self._sos)).to(self._device)
        self.reset()

    @property
    def mode(self) -> str:
        return "tir" if self._tir_taps is not None else "scan"

    def reset(self):
        """Clear filter memory (liquid iirfilt_*_reset)."""
        if self._tir_taps is not None:
            self._state = kfir.fir_init(self._tir_taps.shape[0], self._dtype,
                                        self._device)
        else:
            self._state = kiir.sos_init(self._sos, self._dtype, self._device)

    def freqresponse(self, f):
        """H(e^{j2 pi f}) at f in cycles/sample (liquid iirfilt_*_freqresponse)."""
        return iirdes.sos_freqresponse(self._sos, f)

    def print(self):
        S = len(self._sos)
        print(f"iirfilt [sos: {S} sections, mode: {self.mode}]")
        for s, row in enumerate(self._sos):
            print(f"  {s}: b={row[:3]} a={row[3:]}")

    def __call__(self, inp):
        x = (as_c64 if self._complex else as_f32)(inp, self._device)
        if self._tir_taps is not None:
            self._state, y = kfir.fir_apply(self._tir_taps, self._state, x)
        else:
            self._state, y = biquad_scan.sos_apply_df(self._sos_table, self._state, x)
        return to_numpy(y)


class CIIRFilter(_SosFilterBase):
    """Complex-input IIR from explicit transfer-function coefficient arrays
    (reference wrapper.cpp:30-34: CIIRFilter(Bc, Ac))."""

    def __init__(self, Bc, Ac, mode: str = "auto", *, device=None):
        super().__init__(iirdes.tf2sos(Bc, Ac), complex_data=True, mode=mode,
                         device=device)


class RIIRFilter(_SosFilterBase):
    """Real twin of CIIRFilter."""

    def __init__(self, Bc, Ac, mode: str = "auto", *, device=None):
        super().__init__(iirdes.tf2sos(Bc, Ac), complex_data=False, mode=mode,
                         device=device)


def _designed(band_type, complex_data):
    class _Designed(_SosFilterBase):
        def __init__(self, filter_type="butter", order=None, Fc=None, F0=None,
                     Ap=0.5, As=20.0, mode="auto", *, device=None):
            if order is None or Fc is None:
                raise TypeError("order and Fc are required")
            if band_type in ("bandpass", "bandstop") and F0 is None:
                raise TypeError("F0 is required for band filters")
            # unknown filter_type falls back to butter, as the reference's
            # map lookup does
            if filter_type not in iirdes.FILTER_TYPES:
                filter_type = "butter"
            sos = iirdes.iirdes_sos(filter_type, band_type, order, Fc,
                                    F0 if F0 is not None else 0.1, Ap, As)
            super().__init__(sos, complex_data=complex_data, mode=mode,
                             device=device)
    return _Designed


class CLowpassIIR(_designed("lowpass", True)):
    """Designed complex lowpass IIR: (filter_type='butter', order, Fc,
    Ap=0.5, As=20)."""


class CHighpassIIR(_designed("highpass", True)):
    """Designed complex highpass IIR."""


class CBandpassIIR(_designed("bandpass", True)):
    """Designed complex bandpass IIR, band edges F0 +/- Fc."""


class CBandstopIIR(_designed("bandstop", True)):
    """Designed complex bandstop IIR, band edges F0 +/- Fc."""


class RLowpassIIR(_designed("lowpass", False)):
    """Designed real lowpass IIR."""


class RHighpassIIR(_designed("highpass", False)):
    """Designed real highpass IIR."""


class RBandpassIIR(_designed("bandpass", False)):
    """Designed real bandpass IIR."""


class RBandstopIIR(_designed("bandstop", False)):
    """Designed real bandstop IIR."""


class _FullIIR(_SosFilterBase):
    """One-stop designed IIR with band_type kwarg + readonly design params
    (reference wrapper.cpp:134-172)."""

    _complex_data = True

    def __init__(self, filter_type="butter", band_type="lowpass", order=2,
                 Fc=0.2, F0=0.3, Ap=0.7, As=60.0, mode="auto", *, device=None):
        # readonly attributes; unknown names fall back to the defaults, as
        # the reference's map lookups do
        self.filter_type = filter_type if filter_type in iirdes.FILTER_TYPES else "butter"
        self.band_type = band_type if band_type in iirdes.BAND_TYPES else "lowpass"
        self.order = int(order)
        self.Fc = float(Fc)
        self.F0 = float(F0)
        self.Ap = float(Ap)
        self.As = float(As)
        sos = iirdes.iirdes_sos(self.filter_type, self.band_type, self.order,
                                self.Fc, self.F0, self.Ap, self.As)
        super().__init__(sos, complex_data=self._complex_data, mode=mode,
                         device=device)


class ComplexIIRFilter(_FullIIR):
    """ComplexIIRFilter(filter_type='butter', band_type='lowpass', order=2,
    Fc=0.2, F0=0.3, Ap=0.7, As=60.0)."""
    _complex_data = True


class RealIIRFilter(_FullIIR):
    """Real twin of ComplexIIRFilter."""
    _complex_data = False


class DeemphasisFilter(StatefulOp):
    """FM 75 us de-emphasis one-pole IIR: y[n] = (1-x) u[n] + x y[n-1],
    x = exp(-1/(75e-6 * sample_rate))."""

    def __init__(self, sample_rate=48000, *, device=None):
        self._device = resolve_device(device)
        self._b0, self._a = iirdes.deemphasis_coeffs(sample_rate)
        self.reset()

    def reset(self):
        self._state = torch.tensor(0.0, dtype=torch.float32, device=self._device)

    def freqresponse(self, f):
        sos = np.array([[self._b0, 0.0, 0.0, 1.0, -self._a, 0.0]])
        return iirdes.sos_freqresponse(sos, f)

    def __call__(self, data):
        x = as_f32(data, self._device)
        if x.shape[0] == 0:
            return np.zeros((0,), np.float32)
        self._state, y = first_order.first_order_apply_blocked(
            self._b0, self._a, self._state, x)
        return to_numpy(y)


class RealFIRFilter(StatefulOp):
    """Real FIR from explicit taps: y[n] = sum_k h[k] x[n-k]."""

    def __init__(self, h=None, *, device=None):
        self._device = resolve_device(device)
        if h is not None:
            self._set_taps(np.asarray(h, dtype=np.float64))

    def _set_taps(self, h):
        self._h = h
        self._hj = _f32(h, self._device)
        self.reset()

    def reset(self):
        self._state = kfir.fir_init(len(self._h), torch.float32, self._device)

    def freqresponse(self, f):
        return firdes.freqresponse(self._h, f)

    def __call__(self, inp):
        x = as_f32(inp, self._device)
        self._state, y = kfir.fir_apply(self._hj, self._state, x)
        return to_numpy(y)


class RealDCBlocker(RealFIRFilter):
    """DC-notch FIR: RealDCBlocker(slen=25, As=20)."""

    def __init__(self, slen=25, As=20.0, *, device=None):
        self._device = resolve_device(device)
        self._set_taps(firdes.dc_blocker(slen, As))


class RealKaiserBessel(RealFIRFilter):
    """Kaiser-windowed lowpass FIR, self-normalized to unity DC gain:
    RealKaiserBessel(flen=25, Fc, As=20, offset=0)."""

    def __init__(self, flen=25, Fc=None, As=20.0, offset=0.0, *, device=None):
        if Fc is None:
            raise TypeError("Fc is required")
        self._device = resolve_device(device)
        h = firdes.kaiser_lowpass(flen, Fc, As, offset)
        h = h / abs(firdes.freqresponse(h, 0.0))
        self._set_taps(h)
