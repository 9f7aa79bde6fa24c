"""The FM stereo fidelity checks of tests/test_oracle_composite.py and
tests/test_demod.py as functions (numpy and scipy only), shared by the
port's tests and chip_smoke.py, which loads this file by path."""

import numpy as np


def stereo_composite(n, la, ra, iq_rate=600_000.0, scale=0.04):
    """FM stereo IQ (kd = 4) of the left and right audio la, ra (n,): mono,
    the 19 kHz pilot at 0.1 and the difference on the 38 kHz subcarrier."""
    t = np.arange(n)
    f_p = 19000.0 / iq_rate
    comp = ((la + ra) / 2 + 0.1 * np.cos(2 * np.pi * f_p * t)
            + ((la - ra) / 2) * np.cos(2 * np.pi * 2 * f_p * t)) * scale
    return np.exp(1j * 2 * np.pi * 4.0 * np.cumsum(comp)).astype(np.complex64)


def mono_agreement(y_ref, y, fs=48_000.0):
    """The mono-path comparison: a 10 kHz audio lowpass on both, the second
    half, fractional-delay alignment by 8x resampling and cross-correlation.
    Returns (gain of y over y_ref, SNR of y against the scaled y_ref in
    dB)."""
    import scipy.signal as sig
    h = sig.firwin(201, 10000.0, fs=fs)
    a = np.convolve(np.asarray(y_ref, np.float64), h, mode="valid")
    b = np.convolve(np.asarray(y, np.float64), h, mode="valid")
    m = min(len(a), len(b))
    a, b = a[m // 2:m], b[m // 2:m]
    up = 8
    au, bu = sig.resample(a, up * len(a)), sig.resample(b, up * len(b))
    lag = np.argmax(np.correlate(bu, au, mode="full")) - (len(au) - 1)
    if lag >= 0:
        bu = bu[lag:]
    else:
        au = au[-lag:]
    m = min(len(au), len(bu)) - up * 8
    au, bu = au[:m], bu[:m]
    g = np.dot(au, bu) / np.dot(au, au)
    err = np.mean((g * au - bu) ** 2)
    snr = np.inf if err == 0 else 10.0 * np.log10(np.mean((g * au) ** 2) / err)
    return g, snr


def separation_db(y, f_l, f_r, fs=48_000.0):
    """L / R separation in dB of the tones f_l (left) and f_r (right) over
    the last quarter of y (N, 2): (left's f_l over its f_r, right's f_r
    over its f_l), from the Hann-windowed spectra's peaks."""
    L, R = y[3 * len(y) // 4:, 0], y[3 * len(y) // 4:, 1]
    w = np.hanning(len(L))
    fl = np.fft.rfftfreq(len(L), 1 / fs)
    sL, sR = np.abs(np.fft.rfft(L * w)), np.abs(np.fft.rfft(R * w))
    il, ir = np.argmin(np.abs(fl - f_l)), np.argmin(np.abs(fl - f_r))

    def pk(s, i):
        return np.max(s[i - 3:i + 4])

    return 20 * np.log10(pk(sL, il) / pk(sL, ir)), 20 * np.log10(pk(sR, ir) / pk(sR, il))
