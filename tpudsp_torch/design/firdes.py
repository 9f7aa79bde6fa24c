"""Host-side FIR filter design (float64 NumPy).

A verbatim copy of the designers of ``tpudsp/design/firdes.py`` that the
port needs: the Kaiser lowpass, the FM stereo audio lowpass, the DC
blocker, the Hilbert FIR, the half-band lowpass, the polyphase resampler
bank with its default parameters, and the FIR frequency response. ``tpudsp.design`` cannot be imported here,
because ``tpudsp/__init__.py`` imports jax; tests/test_torch_design.py
holds these copies equal to the originals bit for bit.
"""

from __future__ import annotations

import numpy as np


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


def stereo_audio_lowpass(comp_rate: float, As: float = 60.0) -> np.ndarray:
    """15 kHz audio-band lowpass for FM stereo matrixing at composite rate
    ``comp_rate`` Hz: passband to 15 kHz, stopband from 19 kHz (rejects the
    pilot and every mixing image the pilot-squaring L-R demod leaves above
    the audio band). Tap count from the Kaiser length estimate for the
    4 kHz transition; cutoff centered at 17 kHz. Odd length (symmetric,
    integral group delay)."""
    if comp_rate <= 2 * 19000.0:
        raise ValueError("stereo decoding needs a composite rate > 38 kHz")
    df = 4000.0 / comp_rate
    n = int(np.ceil((abs(As) - 7.95) / (14.36 * df))) | 1
    return kaiser_lowpass(n, 17000.0 / comp_rate, As)


def dc_blocker(m: int, As: float = 20.0) -> np.ndarray:
    """DC-blocking FIR of length 2*m+1 (liquid firfilt_rrrf_create_dc_blocker
    equivalent, reference firfilter.hpp:43).

    Built as delta minus a narrow unity-DC-gain lowpass: the notch width is
    set by the narrowest lowpass realizable at length 2*m+1 for the requested
    stopband As (Kaiser transition-width estimate).
    """
    n = 2 * m + 1
    # Narrowest realizable cutoff for this length/attenuation (Kaiser estimate:
    # transition width df = (As - 7.95) / (14.36 * (n-1))).
    df = (max(abs(As), 12.0) - 7.95) / (14.36 * (n - 1))
    fc = float(np.clip(df, 5e-4, 0.2))
    h_lp = kaiser_lowpass(n, fc, As)
    h_lp /= h_lp.sum()  # exact unity DC gain for the lowpass branch
    h = -h_lp
    h[m] += 1.0
    return h


def hilbert_fir(m: int, As: float = 60.0) -> np.ndarray:
    """Kaiser-windowed Hilbert-transform FIR of length 4*m+1 (liquid firhilbf
    equivalent).

    Odd-length antisymmetric type-III design: h[c + k] = 0 for even k,
    (2/(pi k)) * window for odd k. Group delay is 2*m samples. The companion
    in-phase branch is a pure 2*m-sample delay.
    """
    n = 4 * m + 1
    c = n // 2
    k = np.arange(n, dtype=np.float64) - c
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(k % 2 != 0, 2.0 / (np.pi * k), 0.0)
    h[c] = 0.0
    w = np.kaiser(n, kaiser_beta(As))
    return h * w


def halfband_lowpass(m: int, As: float = 60.0) -> np.ndarray:
    """Half-band lowpass of length 4*m+1 (cutoff 0.25). Even-offset taps are
    exactly zero except the center tap (0.5). Used by HilbertTransform's
    interp/decim paths."""
    n = 4 * m + 1
    c = n // 2
    k = np.arange(n, dtype=np.float64) - c
    h = 0.5 * np.sinc(0.5 * k)  # zeros at even nonzero offsets by construction
    w = np.kaiser(n, kaiser_beta(As))
    h = h * w
    # force exact half-band structure
    mask_even = (k % 2 == 0) & (k != 0)
    h[mask_even] = 0.0
    h[c] = 0.5
    return h


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


def default_resamp_params(rate: float) -> tuple[int, float, float, int]:
    """Parameters for the default-designed resampler
    (liquid resamp_*_create_default equivalent, reference resampler.hpp:12,47):
    semi-length m=7, stopband 60 dB, 64 polyphase banks, anti-alias cutoff at
    45% of the narrower of input/output Nyquist."""
    m = 7
    As = 60.0
    npfb = 64
    fc = 0.45 * min(1.0, float(rate))
    fc = float(np.clip(fc, 1e-4, 0.45))
    return m, fc, As, npfb


def freqresponse(h: np.ndarray, f) -> np.ndarray | complex:
    """Frequency response H(e^{j2 pi f}) of FIR taps ``h`` at frequency/ies
    ``f`` (cycles/sample). Matches liquid firfilt_*_freqresponse semantics
    (reference firfilter.hpp:23-27): H(f) = sum_k h[k] e^{-j 2 pi f k}."""
    f_arr = np.atleast_1d(np.asarray(f, dtype=np.float64))
    k = np.arange(len(h))
    H = np.exp(-2j * np.pi * f_arr[:, None] * k[None, :]) @ np.asarray(h)
    if np.isscalar(f) or np.asarray(f).ndim == 0:
        return complex(H[0])
    return H
