"""The channelized demod bank in float64: BASELINE config 4 (a 1024-channel
polyphase analysis bank, liquid-dsp firpfbch, As 60 dB, and a demodulator
on every channel), written out from its definition.

Channel c of C, critically sampled, frame m at stream sample m C:

    Y[m, c] = sum_k h[k] x[m C - k] e^{2 pi j c k / C}

(the stream mixed down by c / C cycles a sample, filtered by the Kaiser
prototype h of C T taps at unity DC gain, kept every C-th sample; x before
the segment is zero). It is evaluated as its polyphase sum over the
branches k = t C + p and a C-point inverse DFT, in float64 (complex128)
with plain PyTorch on whatever device the caller names.

    FM     : s[m] = arg(Y[m] conj(Y[m-1])) / (2 pi kd), Y[-1] = 1
    AM     : the coherent back end of ``coherent_am_f64`` (AGC, carrier
             PLL, DC tracker) on every channel, vectorised over channels
    pcm    : b0 s[m] + a pcm[m-1], the 75 us de-emphasis at the channel rate
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal as sig
import torch

from . import designs
from .am_chain import DC_RHO, PLL_BW
from .precision import F64, Precision

TWO_PI = 2.0 * math.pi


def prototype(cfg: dict):
    """The analysis bank's prototype h (C T,) in float64, unity DC gain."""
    C, T = cfg["nchan"], cfg["taps_per_branch"]
    h = designs.kaiser_lowpass(C * T, cfg["cutoff_frac"] / C, cfg["As"])
    return h / h.sum()


def channelize_f64(x, h, C: int, device="cpu", prec: Precision = F64):
    """Y (len(x) / C, C) complex128 (a host array) of the segment x."""
    T = len(h) // C
    x = torch.as_tensor(prec.mm(np.asarray(x, np.complex128)), device=device)
    F = x.shape[0] // C
    S = x.reshape(F, C)
    # Z[j, 0] = x[j C], Z[j, p] = x[j C - p] = S[j - 1, C - p] for p > 0
    Z = torch.zeros_like(S)
    Z[:, 0] = S[:, 0]
    Z[1:, 1:] = S[:-1, 1:].flip(1)
    Ht = torch.as_tensor(prec.mm(h.reshape(T, C)), device=device)
    u = torch.zeros_like(S)
    for t in range(T):
        u[t:] += Ht[t] * Z[:F - t]
    del Z, S
    Y = torch.fft.ifft(u, dim=1, norm="forward")
    return prec.el(Y.cpu().numpy())


def discriminate_f64(Y, kd: float, prec: Precision = F64):
    """s (C, F): the FM discriminator down the frames of Y (F, C)."""
    prev = np.concatenate([np.ones((1, Y.shape[1]), Y.dtype), Y[:-1]], 0)
    return prec.el((np.angle(Y * np.conj(prev)) / (TWO_PI * kd)).T)


def coherent_am_f64(Y, cfg: dict, prec: Precision = F64):
    """audio (C, F): the coherent AM back end on every channel of Y (F, C),
    sample by sample from the start state (g = y2p = 1, theta = freq = dc
    = 0), vectorised over the channels."""
    a, scale, mod = cfg["agc_bandwidth"], cfg["agc_scale"], cfg["modulation"]
    alpha, beta = PLL_BW, math.sqrt(PLL_BW)
    r = prec.loop
    F, C = Y.shape
    xr, xi = np.ascontiguousarray(Y.real), np.ascontiguousarray(Y.imag)
    g, y2p = np.ones(C), np.ones(C)
    theta, freq, dc = np.zeros(C), np.zeros(C), np.zeros(C)
    out = np.empty((F, C))
    for m in range(F):
        zr, zi = r(xr[m] * g), r(xi[m] * g)
        y2p = r((1.0 - a) * y2p + a * (zr * zr + zi * zi))
        g = np.minimum(r(g * np.exp(-0.5 * a * np.log(y2p + 1e-30))), 1e6)
        zr, zi = zr * scale, zi * scale
        c, s = np.cos(theta), np.sin(theta)
        vr, vi = r(zr * c + zi * s), r(zi * c - zr * s)
        e = np.arctan2(vi, vr)
        freq = r(freq + alpha * e)
        theta = r(np.mod(theta + beta * e + freq + math.pi, TWO_PI) - math.pi)
        dc = r(DC_RHO * dc + (1.0 - DC_RHO) * vr)
        out[m] = r((vr - dc) / mod)
    return prec.el(out.T)


def deemphasis_f64(s, chan_rate: float, tau: float, prec: Precision = F64):
    """pcm (C, F) = the one-pole de-emphasis along each row of s, from 0."""
    b0, a = designs.deemphasis_coeffs(chan_rate, tau)
    return prec.el(sig.lfilter([b0], [1.0, -a], s, axis=1))


def bank_f64(x, cfg: dict, device="cpu", prec: Precision = F64):
    """The bank's audio (C, len(x) / C) over the segment x for the
    configuration ``cfg`` (its "channelizer" and "bank" groups) and the
    demodulator cfg["bank"]["demod"] ('fm', or 'am' with am_coherent)."""
    ch, bank = cfg["channelizer"], cfg["bank"]
    Y = channelize_f64(x, prototype(ch), ch["nchan"], device, prec)
    if bank["demod"] == "fm":
        s = discriminate_f64(Y, bank["kd"], prec)
    elif bank["demod"] == "am" and bank["am_coherent"]:
        s = coherent_am_f64(Y, bank, prec)
    else:
        raise ValueError(f"no reference for demod {bank['demod']!r} "
                         f"(am_coherent {bank.get('am_coherent')})")
    del Y
    return deemphasis_f64(s, ch["iq_rate"] / ch["nchan"], bank["deemph_tau"], prec)
