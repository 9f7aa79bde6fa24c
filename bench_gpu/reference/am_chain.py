"""The AM receiver chain in float64: the semantics of BASELINE config 1
(python-liquiddsp README.md:26-64), written out stage by stage.

    bb    = cheby2 lowpass (order, bandwidth / iq_rate), as its SOS
            recurrence from zero (scipy's sosfilt)
    y[k]  = dot(X[q_k : q_k + 2m], (1 - w_k) H[b_k] + w_k H[b_k + 1]),
            X = [2m zeros, bb], p_k = k Q / P exactly, q_k = floor(p_k),
            b_k + w_k = frac(p_k) npfb  (the polyphase resampler)
    AGC   : z = y g; y2p = (1 - a) y2p + a |z|^2; g *= exp(-a/2 ln y2p),
            g <= 1e6; out = z scale           (g = y2p = 1 at the start)
    PLL   : v = out e^{-j theta}; e = atan2(Im v, Re v); freq += bw e;
            theta = wrap(theta + sqrt(bw) e + freq)
    DC    : dc = rho dc + (1 - rho) Re v; audio = (Re v - dc) / modulation
    pcm   = b0 audio + a pcm[-1]  (75 us de-emphasis at the pcm rate)

with every carry zero (g, y2p one) at the segment's start. The sample-serial
loops run at the 48 kHz rate in Python floats. The constants PLL_BW and
DC_RHO are the ampmodem semantics the chain states (bandwidth 0.001,
pole 0.9995).
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import scipy.signal as sig

from . import designs
from .precision import F64, Precision

PLL_BW = 0.001
DC_RHO = 0.9995


def rate_pq(cfg: dict):
    """(P, Q): P outputs for every Q inputs."""
    f = Fraction(cfg["pcm_rate"] / cfg["iq_rate"]).limit_denominator(10000)
    return f.numerator, f.denominator


def resample_f64(bb, H, P: int, Q: int, prec: Precision = F64):
    """The polyphase resampler's outputs at p_k = k Q / P for p_k < len(bb)."""
    npfb, ntaps = H.shape[0] - 1, H.shape[1]
    n_out = (len(bb) * P + Q - 1) // Q
    k = np.arange(n_out, dtype=np.int64)
    q = (k * Q) // P
    fb = ((k * Q) % P) / P * npfb
    b = np.floor(fb).astype(np.int64)
    w = (fb - b)[:, None]
    taps = prec.mm((1.0 - w) * H[b] + w * H[b + 1])
    X = np.concatenate([np.zeros(ntaps, bb.dtype), prec.mm(bb)])
    win = X[q[:, None] + np.arange(ntaps)[None, :]]
    return np.sum(win * taps, axis=1)


def _rounder(bits):
    """A scalar rounding to ``bits`` mantissa bits (None: identity)."""
    if bits is None:
        return lambda v: v
    scale = float(1 << (bits + 1))

    def r(v):
        m, e = math.frexp(v)
        return math.ldexp(round(m * scale) / scale, e)
    return r


def back_end_f64(y, cfg: dict, prec: Precision = F64):
    """AGC -> carrier PLL -> DC tracker, sample by sample from the start
    state, over y (n,) complex at the pcm rate. Returns audio (n,)."""
    a, scale, mod = cfg["agc_bandwidth"], cfg["agc_scale"], cfg["modulation"]
    alpha, beta = PLL_BW, math.sqrt(PLL_BW)
    r = _rounder(prec.bits_loop)
    g = y2p = 1.0
    theta = freq = dc = 0.0
    out = np.empty(len(y))
    two_pi, pi = 2.0 * math.pi, math.pi
    for n, (xr, xi) in enumerate(zip(y.real.tolist(), y.imag.tolist())):
        zr, zi = r(xr * g), r(xi * g)
        y2p = r((1.0 - a) * y2p + a * (zr * zr + zi * zi))
        g = min(r(g * math.exp(-0.5 * a * math.log(y2p + 1e-30))), 1e6)
        zr, zi = zr * scale, zi * scale
        c, s = math.cos(theta), math.sin(theta)
        vr, vi = r(zr * c + zi * s), r(zi * c - zr * s)
        e = math.atan2(vi, vr) if (vr or vi) else 0.0
        freq = r(freq + alpha * e)
        theta = r((theta + beta * e + freq + pi) % two_pi - pi)
        dc = r(DC_RHO * dc + (1.0 - DC_RHO) * vr)
        out[n] = r((vr - dc) / mod)
    return out


def am_chain_f64(iq, cfg: dict, prec: Precision = F64):
    """pcm (len(iq) P / Q,) of the chain over the IQ segment ``iq`` (its
    length a multiple of Q), every carry zero at its start."""
    P, Q = rate_pq(cfg)
    iq = prec.mm(np.asarray(iq, np.complex128))
    sos = designs.iirdes_sos("cheby2", "lowpass", cfg["order"],
                             cfg["bandwidth"] / cfg["iq_rate"], As=60.0, Ap=0.5)
    bb = sig.sosfilt(sos, iq)
    H = designs.resamp_bank(cfg["resamp_m"], 0.45 * P / Q, 60.0, cfg["resamp_npfb"])
    y = prec.el(resample_f64(bb, H, P, Q, prec))
    audio = back_end_f64(y, cfg, prec)
    b0, a = designs.deemphasis_coeffs(cfg["pcm_rate"])
    return prec.el(sig.lfilter([b0], [1.0, -a], audio))
