"""Frozen copies of the filter designs the reference needs.

Copied from tpudsp_torch/design/firdes.py (kaiser_beta, kaiser_lowpass,
resamp_bank) and tpudsp_torch/design/iirdes.py (FILTER_TYPES, BAND_TYPES,
iirdes_sos, deemphasis_coeffs) at commit 9750c49 (the port's copies of
tpudsp/design/, held equal to them by tests/test_torch_design.py), so
that the reference designs its own filters and a later change to the
port's designs shows as a difference instead of moving the yardstick.
bench_gpu/tests/test_bench_gpu_reference.py holds each against its
float64 definition.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sig

FILTER_TYPES = ("butter", "cheby1", "cheby2", "ellip", "bessel")
BAND_TYPES = ("lowpass", "highpass", "bandpass", "bandstop")


def kaiser_beta(As: float) -> float:
    """Kaiser window shape parameter from stopband attenuation in dB."""
    As = abs(float(As))
    if As > 50.0:
        return 0.1102 * (As - 8.7)
    if As > 21.0:
        return 0.5842 * (As - 21.0) ** 0.4 + 0.07886 * (As - 21.0)
    return 0.0


def kaiser_lowpass(n: int, fc: float, As: float = 60.0, mu: float = 0.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, ``n`` taps, cutoff ``fc`` (cycles/sample,
    0 < fc <= 0.5), stopband ``As`` dB, fractional sample offset ``mu``.

    Matches the parameterization of liquid's firfilt_rrrf_create_kaiser.
    DC gain is approximately unity (exactly 2*fc * sum(sinc)); callers that
    need exact unity DC gain normalize explicitly.
    """
    if n < 1:
        raise ValueError("kaiser_lowpass: need n >= 1")
    if not (0.0 < fc <= 0.5):
        raise ValueError(f"kaiser_lowpass: fc must be in (0, 0.5], got {fc}")
    beta = kaiser_beta(As)
    k = np.arange(n, dtype=np.float64)
    t = k - (n - 1) / 2.0 + mu
    h = 2.0 * fc * np.sinc(2.0 * fc * t)
    w = np.kaiser(n, beta)
    return (h * w).astype(np.float64)


def resamp_bank(m: int, fc: float, As: float, npfb: int) -> np.ndarray:
    """Polyphase filterbank for the arbitrary-rate resampler (liquid
    resamp_rrrf/crcf/cccf equivalent).

    Prototype: Kaiser lowpass of length 2*m*npfb + 1 designed at the
    npfb-times-upsampled rate with cutoff fc/npfb (fc normalized to the
    *input* rate).

    Returns ``H`` of shape (npfb + 1, 2*m): row ``b`` holds the taps for
    fractional phase b/npfb; row ``npfb`` is row 0 advanced one input sample
    so that linear interpolation between adjacent rows is valid for the
    whole phase range [0, 1). Output at continuous position p = q + f uses
    input window X[q : q+2m] with taps H[round-down(f*npfb)] linearly
    interpolated toward the next row.
    """
    if not (0.0 < fc <= 0.5):
        raise ValueError(f"resamp_bank: fc must be in (0, 0.5], got {fc}")
    L = 2 * m * npfb + 1
    h = kaiser_lowpass(L, fc / npfb, As)
    # normalize prototype to unity DC gain at the upsampled rate, then scale
    # by npfb so each polyphase row has ~unity DC gain
    h = h / h.sum() * npfb
    c = L // 2  # = m * npfb
    # taps_f[i] = g(f + m - i) with g(t) = npfb * h[npfb*t + c], i = 0..2m-1
    # integer lattice: H[b][i] = h[b + (m - i)*npfb + c] = h[b + (2m - i)*npfb]
    hp = np.concatenate([h, np.zeros(npfb + 1)])
    i = np.arange(2 * m)
    b = np.arange(npfb + 1)
    idx = b[:, None] + (2 * m - i)[None, :] * npfb
    idx = np.clip(idx, 0, len(hp) - 1)
    H = hp[idx]
    return H


def iirdes_sos(
    filter_type: str = "butter",
    band_type: str = "lowpass",
    order: int = 2,
    Fc: float = 0.2,
    F0: float = 0.3,
    Ap: float = 0.5,
    As: float = 20.0,
) -> np.ndarray:
    """Design an IIR filter, returning float64 SOS array of shape (S, 6).

    filter_type in {butter, cheby1, cheby2, ellip, bessel}, band_type in
    {lowpass, highpass, bandpass, bandstop}; unknown names raise.
    """
    if filter_type not in FILTER_TYPES:
        raise ValueError(f"iirdes_sos: unknown filter_type {filter_type!r}")
    if band_type not in BAND_TYPES:
        raise ValueError(f"iirdes_sos: unknown band_type {band_type!r}")
    order = int(order)
    if order < 1:
        raise ValueError(f"iirdes_sos: order must be >= 1, got {order}")

    if band_type in ("lowpass", "highpass"):
        if not (0.0 < Fc < 0.5):
            raise ValueError(f"iirdes_sos: Fc must be in (0, 0.5), got {Fc}")
        Wn = 2.0 * Fc  # scipy normalizes to Nyquist
    else:
        lo = max(1e-5, F0 - Fc)
        hi = min(0.5 - 1e-5, F0 + Fc)
        if not lo < hi:
            raise ValueError(
                f"iirdes_sos: invalid band edges from F0={F0}, Fc={Fc}"
            )
        Wn = [2.0 * lo, 2.0 * hi]

    kwargs = {}
    if filter_type in ("cheby1", "ellip"):
        kwargs["rp"] = float(Ap)
    if filter_type in ("cheby2", "ellip"):
        kwargs["rs"] = float(As)

    sos = sig.iirfilter(
        N=order,
        Wn=Wn,
        btype=band_type,
        ftype=filter_type,
        output="sos",
        **kwargs,
    )
    return np.asarray(sos, dtype=np.float64)


def deemphasis_coeffs(sample_rate: float, tau: float = 75e-6) -> tuple[float, float]:
    """FM de-emphasis one-pole coefficients: y[n] = (1-x) u[n] + x y[n-1],
    x = exp(-1/(tau * sample_rate)), i.e. b0 = 1-x, a = [1, -x]."""
    x = float(np.exp(-1.0 / (tau * float(sample_rate))))
    return 1.0 - x, x
