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
        d = y * np.conj(np.concatenate([[1.0 + 0.0j], y[:-1]]))
        audio.append(decimated_fir(np.angle(d) / (2 * np.pi * kd), h2, D2))
    audio = np.stack(audio)
    pcm = np.empty_like(audio)
    prev = np.zeros(audio.shape[0])
    for j in range(audio.shape[1]):
        prev = b0 * audio[:, j] + a * prev
        pcm[:, j] = prev
    return pcm
