"""NCO mixing with a 32-bit modular phase (port of ``tpudsp/kernels/nco.py``).

liquid's ``nco_crcf`` keeps the oscillator phase in a 32-bit integer
accumulator; so does this: theta[n] = phase + n * dtheta (mod 2^32) is a
closed form over the block, not a recurrence. torch cannot add uint32
tensors on the CPU, so the phases are int64 masked to 32 bits, and the
float angle is converted from that unsigned value, as the JAX package
converts its uint32. The carried phase and the increment are host
integers in [0, 2^32).
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi
_U32_TO_RAD = float(np.float32(TWO_PI / 4294967296.0))
MASK = 0xFFFFFFFF


def rad_to_u32(theta: float) -> int:
    """Radians -> 32-bit phase units (mod 2 pi)."""
    t = float(theta) % TWO_PI
    return int(round(t / TWO_PI * 4294967296.0)) & MASK


def u32_to_rad(u: int) -> float:
    return float(u) * TWO_PI / 4294967296.0


def mul_u32(a, b):
    """(a * b) mod 2^32 for int64 tensors (or ints) holding values in [0,
    2^32): a is split in 16-bit halves, so no intermediate passes 2^49
    (the plain product of two 32-bit values overflows int64)."""
    return ((((a >> 16) * b & MASK) << 16) + (a & 0xFFFF) * b) & MASK


def nco_angles(phase_u, dtheta_u: int, n: int, device=None):
    """Per-sample oscillator angles of an n-sample block: (theta (n,) f32,
    next phase). phase_u is a host int or an int64 0-d tensor on
    ``device`` (the next phase is of the same kind). Exact modular
    arithmetic; the f32 angle keeps its error below 2^-24 * 2 pi."""
    k = torch.arange(n, dtype=torch.int64, device=device)
    th_u = (phase_u + k * dtheta_u) & MASK
    theta = th_u.to(torch.float32) * _U32_TO_RAD
    return theta, (phase_u + n * dtheta_u) & MASK


def _mix(phase_u: int, dtheta_u: int, x, sign: float):
    theta, nxt = nco_angles(phase_u, dtheta_u, x.shape[0], x.device)
    osc = torch.polar(torch.ones_like(theta), sign * theta)
    return nxt, x * osc


def mix_up(phase_u: int, dtheta_u: int, x):
    """y[n] = x[n] e^{+j theta[n]} (liquid nco_crcf_mix_block_up). Returns
    (next_phase, y)."""
    return _mix(phase_u, dtheta_u, x, 1.0)


def mix_down(phase_u: int, dtheta_u: int, x):
    """y[n] = x[n] e^{-j theta[n]} (liquid nco_crcf_mix_block_down).
    Returns (next_phase, y)."""
    return _mix(phase_u, dtheta_u, x, -1.0)
