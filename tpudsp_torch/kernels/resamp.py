"""Host-side resampler output plan (port of ``plan`` in
``tpudsp/kernels/resamp.py``): the one piece of the polyphase resampler
that the fused AM receiver's ``build`` needs.

Output k sits at continuous input position p_k = tau + k / rate, for all
p_k < N; new tau = tau + n_out / rate - N (long-run exact rate).
"""

from __future__ import annotations

import numpy as np


def plan(tau: float, n_in: int, rate: float):
    """Host-side output plan (float64): number of outputs and their integer /
    fractional positions. Returns (n_out, q (i32 ndarray), frac (f32 ndarray),
    new_tau)."""
    rate = float(rate)
    tau = float(tau)
    n_out = int(np.floor((n_in - tau) * rate - 1e-9)) + 1 if tau < n_in else 0
    n_out = max(n_out, 0)
    k = np.arange(n_out, dtype=np.float64)
    p = tau + k / rate
    q = np.floor(p).astype(np.int32)
    frac = (p - q).astype(np.float32)
    new_tau = tau + n_out / rate - n_in
    return n_out, q, frac, new_tau
