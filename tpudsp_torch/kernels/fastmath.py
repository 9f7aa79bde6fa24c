"""``patan2``: the polynomial atan2 of ``tpudsp/kernels/fastmath.py`` on
tensors.

The TPU kernel of the AM back end computes its PLL phase error with this
polynomial (Mosaic has no atan2), so the port's kernel and its plain
version use it too: the same six coefficients, the same Horner order from
the last coefficient, f32 constants and octant reconstruction. Max abs
error ~2e-6 rad against libm atan2; returns 0 at (0, 0).
"""

from __future__ import annotations

import numpy as np
import torch

# odd-polynomial coefficients for atan(z), z in [-1, 1]
_C = (
    0.99997726, -0.33262347, 0.19354346, -0.11643287, 0.05265332, -0.01172120,
)
# the f32 values of pi/2 and pi, as the JAX package's jnp.float32 constants
_HALF_PI = float(np.float32(np.pi / 2))
_PI = float(np.float32(np.pi))


def _atan_unit(z):
    """atan(z) for |z| <= 1 via odd polynomial in z^2."""
    z2 = z * z
    acc = torch.full_like(z, _C[-1])
    for c in _C[-2::-1]:
        acc = acc * z2 + c
    return z * acc


def patan2(y, x):
    """atan2(y, x) -> (-pi, pi], elementwise on f32 tensors."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    safe_hi = torch.where(hi > 0, hi, 1.0)
    t = lo / safe_hi
    a = _atan_unit(t)
    a = torch.where(ay > ax, _HALF_PI - a, a)   # swap fix
    a = torch.where(x < 0, _PI - a, a)          # left half-plane
    a = torch.where(y < 0, -a, a)               # lower half-plane
    return torch.where(hi > 0, a, 0.0)
