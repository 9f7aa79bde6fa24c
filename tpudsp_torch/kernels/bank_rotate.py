"""The receiver bank's output rotation and FM discriminator in one pass:
the plain version of ``csrc/bank_rotate.cu``, bit for bit.

``chains/bank.bank_step`` mixes each channel down inside its channel
filter, so the filter's output y1m (C, nj) still turns at the channel's
offset: output m of channel c is rotated by e^{-j theta[c, m]}, with theta
from the uint32 phase lattice (``chains/bank.phase_lattice``). An FM bank
then takes the discriminator of the rotated rows. This function does both,
in the kernel's order of operations.
"""

from __future__ import annotations

import numpy as np
import torch

from .fastmath import patan2
from .nco import _U32_TO_RAD, MASK, mul_u32


def fm_base(y1m, phase, n0, dtheta, D1: int, fd_prev, kd: float):
    """The FM discriminator rows of y1m (C, nj) complex64 rotated by the
    phase lattice, and the last rotated sample of each channel.

    The angle of output m of channel c is (phase_c + n0 dtheta_c) + m
    (dtheta_c D1) mod 2^32 (phase, dtheta (C,) and n0 0-d: int64 in [0,
    2^32)), rounded to the nearest f32 and scaled by 2 pi / 2^32. The
    sample is rotated by the cosine and sine of minus that angle as four
    real products, wr = yr c - yi s and wi = yr s + yi c. Its value is
    patan2(di, dr) / f32(2 pi kd) with the conjugate product of the rotated
    sample before it (fd_prev (C,) complex64 before output 0): dr = wr pr +
    wi pi and di = wi pr - wr pi, and a true divide. Returns (the (C, nj)
    f32 rows, the (C,) complex64 last rotated samples)."""
    nj = y1m.shape[1]
    m = torch.arange(nj, dtype=torch.int64, device=y1m.device)
    start = (phase + mul_u32(n0, dtheta)) & MASK
    u = (start[:, None] + mul_u32(m[None, :], mul_u32(dtheta, D1)[:, None])) & MASK
    theta = u.to(torch.float32) * _U32_TO_RAD
    rot = torch.polar(torch.ones_like(theta), -theta)
    c, s = rot.real, rot.imag
    yr, yi = y1m.real, y1m.imag
    wr = yr * c - yi * s
    wi = yr * s + yi * c
    pr = torch.cat([fd_prev.real[:, None], wr[:, :-1]], 1)
    pi = torch.cat([fd_prev.imag[:, None], wi[:, :-1]], 1)
    dr = wr * pr + wi * pi
    di = wi * pr - wr * pi
    # a tensor on y1m's device: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal
    div = torch.tensor(np.float32(2.0 * np.pi * kd), device=y1m.device)
    return patan2(di, dr) / div, torch.complex(wr[:, -1], wi[:, -1])
