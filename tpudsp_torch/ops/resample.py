"""Arbitrary-rate resampler op classes (port of ``tpudsp/ops/resample.py``).

Mirrors: RResampler, CResampler (default design), RealResampler,
ComplexResampler (fully parameterized).

The output length varies call to call to keep the long-run rate exact; the
count is planned on the host in float64 from the carried fractional phase
(``kernels/resamp.plan``), so it equals the JAX op's exactly. Setting
``rate`` keeps the filter tail and phase (liquid resamp_set_rate).
"""

from __future__ import annotations

import numpy as np
import torch

from ..design import firdes
from ..kernels import resamp as krs
from .base import (
    StatefulOp, as_c64, as_f32, resolve_device, to_numpy, to_tensor,
)


class _ResamplerBase(StatefulOp):
    def __init__(self, rate, m, Fc, As, npfb, complex_data, device=None):
        if not rate > 0:
            raise ValueError("rate must be positive")
        self._device = resolve_device(device)
        self._rate = float(rate)
        self._m = int(m)
        self._Fc = float(Fc)
        self._As = float(As)
        self._npfb = int(npfb)
        self._complex = complex_data
        self._dtype = torch.complex64 if complex_data else torch.float32
        H = firdes.resamp_bank(self._m, self._Fc, self._As, self._npfb)
        self._H = torch.tensor(H.astype(np.float32), device=self._device)
        self.reset()

    def reset(self):
        """Clear filter tail and fractional phase (liquid resamp_*_reset)."""
        self._tau = 0.0
        self._state = krs.resamp_init(2 * self._m, self._dtype, self._device)

    @property
    def state(self):
        """Full checkpointable state: filter tail + fractional phase."""
        return {"tail": to_numpy(self._state), "tau": self._tau}

    def with_state(self, state):
        self._state = to_tensor(state["tail"], self._device)
        self._tau = float(state["tau"])
        return self

    @property
    def rate(self):
        return self._rate

    @rate.setter
    def rate(self, r):
        # liquid resamp_*_set_rate keeps the filter state; only the rate
        # changes
        if not r > 0:
            raise ValueError("rate must be positive")
        self._rate = float(r)

    def print(self):
        print(
            f"resamp [rate: {self._rate:.6f}, m: {self._m}, Fc: {self._Fc:.4f}, "
            f"As: {self._As:.1f} dB, npfb: {self._npfb}, tau: {self._tau:.6f}]"
        )

    def __call__(self, inp):
        x = (as_c64 if self._complex else as_f32)(inp, self._device)
        n_out, q, frac, new_tau = krs.plan(self._tau, int(x.shape[0]), self._rate)
        if n_out == 0:
            self._state = torch.cat([self._state, x])[-2 * self._m:]
            self._tau = new_tau
            return np.zeros((0,), np.complex64 if self._complex else np.float32)
        self._state, y = krs.resamp_apply(
            self._H, self._state, x, torch.from_numpy(q).to(self._device),
            torch.from_numpy(frac).to(self._device))
        self._tau = new_tau
        return to_numpy(y)


class RResampler(_ResamplerBase):
    """Real arbitrary-rate resampler, default design: RResampler(rate)."""

    def __init__(self, rate, *, device=None):
        m, fc, As, npfb = firdes.default_resamp_params(rate)
        super().__init__(rate, m, fc, As, npfb, complex_data=False,
                         device=device)


class CResampler(_ResamplerBase):
    """Complex twin of RResampler."""

    def __init__(self, rate, *, device=None):
        m, fc, As, npfb = firdes.default_resamp_params(rate)
        super().__init__(rate, m, fc, As, npfb, complex_data=True,
                         device=device)


class RealResampler(_ResamplerBase):
    """Fully parameterized real resampler: RealResampler(rate, len=20, Fc,
    As=60, nfilter=13). ``len`` is the polyphase semi-length, ``nfilter``
    the polyphase bank count, ``Fc`` the anti-alias cutoff normalized to
    the input rate."""

    def __init__(self, rate, len=20, Fc=None, As=60.0, nfilter=13, *,
                 device=None):
        if Fc is None:
            raise TypeError("Fc is required")
        super().__init__(rate, len, Fc, As, nfilter, complex_data=False,
                         device=device)


class ComplexResampler(_ResamplerBase):
    """Complex twin of RealResampler."""

    def __init__(self, rate, len=20, Fc=None, As=60.0, nfilter=13, *,
                 device=None):
        if Fc is None:
            raise TypeError("Fc is required")
        super().__init__(rate, len, Fc, As, nfilter, complex_data=True,
                         device=device)
