"""A float64 oracle of the receiver bank's FM channels (numpy only),
shared by the port's tests and chip_smoke.py, which loads this file by
path.

Channel c of the bank, written out sample by sample in float64 from the
stream's start (every carry zero, the discriminator's previous sample
1 + 0j), with no blocking, no phase lattice and no folded taps:

    x_c[n]  = iq[n] e^{-j theta_c(n)},  theta_c(n) = 2 pi (dtheta_c n mod 2^32) / 2^32
    y_c[m]  = sum_k x_c[m D1 - k] h1[k]            (channel lowpass, every D1-th)
    s_c[m]  = arg(y_c[m] conj(y_c[m-1])) / (2 pi kd)
    a_c[j]  = sum_k s_c[j D2 - k] h2[k]            (audio lowpass, every D2-th)
    pcm[j]  = b0 a_c[j] + a pcm[j-1]               (de-emphasis)

dtheta_c is the channel's 32-bit phase increment (the bank's design);
h1, h2 are the float64 lowpass designs in natural order.

The polyphase channelizer by its definition, not by its filter bank
(``channelizer_f64``): channel c of C with prototype h and hop R = C / os,

    Y[m, c] = sum_k x[m R - k] e^{-2 pi j c ((m R - k) mod C) / C} h[k]

i.e. the stream mixed down by c / C cycles a sample, filtered by h and
kept every R-th sample; ``fm_demod_f64`` is the FM bank's discriminator
and de-emphasis on such channel rows.
"""

import numpy as np


def decimated_fir(x, h, D: int):
    """y[m] = sum_k x[m D - k] h[k] for m < len(x) // D, x[< 0] = 0, in
    float64 (complex or real), by polyphase frames."""
    x = np.asarray(x)
    K = len(h)
    nj = len(x) // D
    Kc = -(-K // D)
    hf = np.zeros(Kc * D)
    hf[:K] = np.asarray(h, np.float64)[::-1]      # correlation order
    Xp = np.concatenate([np.zeros(K - 1, x.dtype), x,
                         np.zeros((nj + Kc) * D, x.dtype)])
    F = Xp[:(nj + Kc - 1) * D].reshape(-1, D)
    hb = hf.reshape(Kc, D)
    y = np.zeros(nj, np.result_type(x.dtype, np.float64))
    for c in range(Kc):
        y += F[c:c + nj] @ hb[c]
    return y


def fm_bank_f64(iq, dtheta, h1, h2, D1: int, D2: int, kd: float, b0: float,
                a: float):
    """The FM bank's audio (C, len(iq) // (D1 D2)) in float64 for the
    channels' phase increments ``dtheta`` (C,) (ints in [0, 2^32))."""
    iq = np.asarray(iq, np.complex128)
    n = np.arange(len(iq), dtype=np.uint64)
    audio = []
    for dt in dtheta:
        th = ((n * np.uint64(dt)) & np.uint64(0xFFFFFFFF)).astype(np.float64)
        y = decimated_fir(iq * np.exp(-2j * np.pi * th / 2.0 ** 32), h1, D1)
        audio.append(decimated_fir(discriminate_f64(y, kd), h2, D2))
    return deemphasis_f64(np.stack(audio), b0, a)


def discriminate_f64(y, kd: float):
    """s[m] = arg(y[m] conj(y[m-1])) / (2 pi kd) along the last axis, y[-1]
    = 1 + 0j."""
    y = np.asarray(y, np.complex128)
    prev = np.concatenate([np.ones(y.shape[:-1] + (1,), y.dtype), y[..., :-1]], -1)
    return np.angle(y * np.conj(prev)) / (2 * np.pi * kd)


def deemphasis_f64(audio, b0: float, a: float):
    """pcm[j] = b0 audio[j] + a pcm[j-1] along the last axis of (C, n), from
    0."""
    audio = np.asarray(audio, np.float64)
    pcm = np.empty_like(audio)
    prev = np.zeros(audio.shape[0])
    for j in range(audio.shape[1]):
        prev = b0 * audio[:, j] + a * prev
        pcm[:, j] = prev
    return pcm


def channelizer_f64(x, h, C: int, os: int, channels):
    """The channelizer's output Y (len(x) os // C, len(channels)) in
    float64 for the given channels, from the stream's start (x[< 0] = 0),
    with the prototype h (C T,) in natural order."""
    x = np.asarray(x, np.complex128)
    ph = (np.arange(len(x)) % C) / C
    return np.stack([decimated_fir(x * np.exp(-2j * np.pi * c * ph), h, C // os)
                     for c in channels], 1)


def fm_demod_f64(y, kd: float, b0: float, a: float):
    """The FM bank's discriminator and de-emphasis over channel rows y
    (C, M), in float64."""
    return deemphasis_f64(discriminate_f64(y, kd), b0, a)
