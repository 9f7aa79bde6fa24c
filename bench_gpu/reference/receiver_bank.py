"""The 16-channel receiver bank in float64: BASELINE config 3 (a shared IQ
stream, and for each channel an NCO mix-down, a decimating channel filter
and a demodulator, then an audio decimator and the de-emphasis; liquid-dsp's
nco, firfilt and freqdem), written out from its definition.

Channel c at w_c = 2 pi f_c / iq_rate, over a segment x of the stream that
starts at n = 0 (x before the segment is zero):

    y_c[m]   = sum_k h1[k] x[m D1 - k] e^{-j w_c (m D1 - k)}
               h1 = kaiser_lowpass(taps1, 0.45 / D1, 60)
    s_c[m]   = arg(y_c[m] conj(y_c[m-1])) / (2 pi kd),   y_c[-1] = 1
    a_c[j]   = sum_k h2[k] s_c[j D2 - k]
               h2 = kaiser_lowpass(taps2, 0.45 / D2, 60)
    pcm_c[j] = b0 a_c[j] + a pcm_c[j-1],   (b0, a) = deemphasis_coeffs(audio rate)

The mix-down and the channel filter run channel by channel in complex128
with plain PyTorch on the device the caller names (so two blocks of the
stream and the prefix fit beside the program's ring); the rest runs on the
host in numpy and scipy.

Where the program departs from this, and why it does not matter here:

- The program folds the mix into the filter (one complex filter with the
  taps h1[k] e^{+j w_c k}, then the rotation e^{-j w_c m D1}); the two are
  one sum.
- The program's rotation comes from a uint32 phase lattice: w_c rounded to
  2 pi / 2^32 (a frequency error under 1 mHz at 2.4 Msps) and the phase
  counted from the stream's first sample, its angle rounded to float32.
  This reference takes the exact w_c and counts the phase from the
  segment's start. A phase offset that stays constant on a channel does
  not change the discriminator.
- The program's discriminator is ``patan2``, a polynomial atan2 in
  float32; this one is ``np.angle`` in float64.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal as sig
import torch

from . import designs
from .precision import F64, Precision

TWO_PI = 2.0 * math.pi


def round_bits(t: torch.Tensor, bits: int) -> torch.Tensor:
    """``precision.round_bits`` on a (complex) float64 tensor on its own
    device: through float32, then round to nearest even at ``bits``
    mantissa bits."""
    if t.is_complex():
        return torch.complex(round_bits(t.real, bits), round_bits(t.imag, bits))
    u = t.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    drop = 23 - bits
    odd = (u >> drop) & 1
    u = (((u + (1 << (drop - 1)) - 1 + odd) >> drop) << drop) & 0xFFFFFFFF
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32).to(torch.float64)


def _mm(t: torch.Tensor, prec: Precision) -> torch.Tensor:
    return t if prec.bits_mm is None else round_bits(t, prec.bits_mm)


def channel_f64(x: torch.Tensor, f_hz: float, cfg: dict, prec: Precision = F64):
    """y (len(x) / D1,) complex128 on x's device: the segment x (complex128)
    mixed down by f_hz, through h1, kept every D1-th sample."""
    D1, K = cfg["decim1"], cfg["taps1"]
    h1 = designs.kaiser_lowpass(K, 0.45 / D1, 60.0)
    n = torch.arange(x.shape[0], dtype=torch.float64, device=x.device)
    cycles = torch.remainder(n * (f_hz / cfg["iq_rate"]), 1.0)
    z = torch.polar(torch.ones_like(cycles), -TWO_PI * cycles)
    del n, cycles
    z = _mm(z.mul_(x), prec)
    zp = torch.cat([torch.zeros(K - 1, dtype=z.dtype, device=z.device), z])
    del z
    M = x.shape[0] // D1
    y = torch.zeros(M, dtype=torch.complex128, device=x.device)
    for k, hk in enumerate(prec.mm(h1)):
        # zp[m D1 + K-1 - k] = z[m D1 - k]
        y.add_(zp[K - 1 - k:K - 1 - k + (M - 1) * D1 + 1:D1], alpha=float(hk))
    return y.cpu().numpy()


def discriminate_f64(y, kd: float, prec: Precision = F64):
    """s (len(y),): the FM discriminator along y, y[-1] = 1."""
    prev = np.concatenate([[1.0 + 0.0j], y[:-1]])
    return prec.el(np.angle(y * np.conj(prev)) / (TWO_PI * kd))


def audio_f64(s, cfg: dict, prec: Precision = F64):
    """pcm (len(s) / D2,): s through h2 kept every D2-th sample, then the
    de-emphasis at the audio rate, both from zero."""
    D2 = cfg["decim2"]
    h2 = designs.kaiser_lowpass(cfg["taps2"], 0.45 / D2, 60.0)
    a = prec.el(sig.lfilter(prec.mm(h2), [1.0], prec.mm(s))[::D2])
    b0, pole = designs.deemphasis_coeffs(cfg["iq_rate"] / cfg["decim1"] / D2)
    return prec.el(sig.lfilter([b0], [1.0, -pole], a))


def receiver_bank_f64(x, cfg: dict, device="cpu", prec: Precision = F64):
    """The bank's audio (C, len(x) / (D1 D2)) over the segment x for the
    configuration ``cfg`` (iq_rate, freqs, decim1, decim2, taps1, taps2, kd,
    and demod 'fm'). Channel by channel: one channel's mix-down and filter
    on ``device`` at a time."""
    if cfg["demod"] != "fm":
        raise ValueError(f"no reference for demod {cfg['demod']!r} (use 'fm')")
    xd = torch.as_tensor(np.asarray(x, np.complex128), device=device)
    out = []
    for f in cfg["freqs"]:
        y = prec.el(channel_f64(xd, f, cfg, prec))
        out.append(audio_f64(discriminate_f64(y, cfg["kd"], prec), cfg, prec))
    return np.stack(out)
