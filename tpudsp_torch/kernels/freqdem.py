"""FM demodulation (port of ``tpudsp/kernels/freqdem.py``), liquid's
``freqdem``: y[n] = arg(conj(x[n-1]) x[n]) / (2 pi kd), block-parallel
given the previous block's last sample, with the polynomial atan2
``kernels/fastmath.patan2`` as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from .fastmath import patan2

TWO_PI = np.float32(2.0 * np.pi)


def freqdem_init(device=None):
    """liquid resets r_prime to 1+0j (zero initial phase difference)."""
    return torch.tensor(1.0 + 0.0j, dtype=torch.complex64, device=device)


def freqdem_apply(kd: float, prev, x):
    """prev: complex64 0-d (last sample of the previous block); x: (N,)
    complex64. Returns (new_prev, y) with y float32."""
    xprev = torch.cat([prev.reshape(1), x[:-1]])
    d = x * torch.conj(xprev)
    y = patan2(d.imag, d.real) / float(TWO_PI * np.float32(kd))
    return x[-1], y
