"""Host-side IIR filter design (float64, SciPy-backed).

A copy of the designers of ``tpudsp/design/iirdes.py`` that the port
needs: analog prototype (butter/cheby1/cheby2/ellip/bessel) -> bilinear
transform -> second-order-section cascade, its frequency response and
truncated impulse response, and the de-emphasis one-pole. tests/test_torch_design.py holds
them equal to the originals bit for bit.

Band-type semantics:
- lowpass/highpass: cutoff ``Fc`` in cycles/sample, 0 < Fc < 0.5.
- bandpass/bandstop: band edges at ``F0 -/+ Fc`` (center F0, half-width Fc),
  clipped to (0, 0.5).
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sig

FILTER_TYPES = ("butter", "cheby1", "cheby2", "ellip", "bessel")
BAND_TYPES = ("lowpass", "highpass", "bandpass", "bandstop")


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


def tf2sos(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Transfer-function (B, A) coefficient arrays -> SOS cascade (float64)."""
    b = np.asarray(b, dtype=np.float64).ravel()
    a = np.asarray(a, dtype=np.float64).ravel()
    if a.size < 1 or a[0] == 0.0:
        raise ValueError("tf2sos: a[0] must be nonzero")
    if b.size <= 3 and a.size <= 3:
        # already a single biquad (or lower order) -- avoid root-finding noise
        bb = np.zeros(3)
        aa = np.zeros(3)
        bb[: b.size] = b
        aa[: a.size] = a
        bb /= a[0]
        aa /= a[0]
        return np.concatenate([bb, aa])[None, :]
    return np.asarray(sig.tf2sos(b, a), dtype=np.float64)


def deemphasis_coeffs(sample_rate: float, tau: float = 75e-6) -> tuple[float, float]:
    """FM de-emphasis one-pole coefficients: y[n] = (1-x) u[n] + x y[n-1],
    x = exp(-1/(tau * sample_rate)), i.e. b0 = 1-x, a = [1, -x]."""
    x = float(np.exp(-1.0 / (tau * float(sample_rate))))
    return 1.0 - x, x


def sos_freqresponse(sos: np.ndarray, f) -> np.ndarray | complex:
    """H(e^{j 2 pi f}) of an SOS cascade at frequency/ies ``f`` in
    cycles/sample (liquid iirfilt_*_freqresponse semantics,
    reference iirfilter.hpp:46-50)."""
    f_arr = np.atleast_1d(np.asarray(f, dtype=np.float64))
    _, H = sig.sosfreqz(np.asarray(sos), worN=2.0 * np.pi * f_arr, fs=2.0 * np.pi)
    if np.isscalar(f) or np.asarray(f).ndim == 0:
        return complex(H[0])
    return H


def sos_impulse_response(
    sos: np.ndarray, tol: float = 1e-13, max_len: int = 1 << 17
) -> np.ndarray | None:
    """Truncated impulse response of a stable SOS cascade, or None if the
    response has not decayed below ``tol`` (relative tail energy) within
    ``max_len`` samples. Exactness vs. the true recurrence is bounded by the
    discarded tail energy (<= tol)."""
    sos = np.asarray(sos, dtype=np.float64)
    x = np.zeros(max_len)
    x[0] = 1.0
    h = sig.sosfilt(sos, x)
    energy = np.cumsum(h[::-1] ** 2)[::-1]  # tail energy from index k on
    total = energy[0]
    if total == 0.0:
        return h[:1]
    keep = np.nonzero(energy > tol * total)[0]
    if keep.size == 0:
        return h[:1]
    k = int(keep[-1]) + 1
    if k >= max_len:
        return None  # pole too close to unit circle -- caller uses scan mode
    return h[:k]
