"""Polyphase arbitrary-rate resampler (port of ``tpudsp/kernels/resamp.py``).

Output k sits at continuous input position p_k = tau + k / rate, for all
p_k < N; new tau = tau + n_out / rate - N (long-run exact rate). The count
and positions are planned on the host in float64 (``plan``), so the
device work is a gather of windows and an interpolated polyphase dot
(``resamp_apply``):

    X   = [tail (2m samples), x (N samples)]
    y_k = dot(X[q_k : q_k + 2m], taps(frac_k))

with taps linearly interpolated between polyphase rows floor(frac*npfb)
and the next (bank from ``design/firdes.resamp_bank``).
"""

from __future__ import annotations

import numpy as np
import torch


def resamp_init(ntaps: int, dtype=torch.float32, device=None):
    """Zero tail of 2m (= ntaps) input samples."""
    return torch.zeros((ntaps,), dtype=dtype, device=device)


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


def resamp_apply(H, tail, x, q, frac):
    """H: (npfb+1, 2m) float32; tail: (2m,); x: (N,); q: (n_out,) integer
    window starts into X; frac: (n_out,) float32 in [0, 1).
    Returns (new_tail, y (n_out,))."""
    ntaps = H.shape[1]
    npfb = H.shape[0] - 1
    X = torch.cat([tail.to(x.dtype), x])
    win = X[q.long()[:, None] + torch.arange(ntaps, device=X.device)[None, :]]
    fb = frac * npfb
    b = torch.clamp(fb.to(torch.int32), 0, npfb - 1).long()
    w = (fb - b.float())[:, None]
    taps = H[b] * (1.0 - w) + H[b + 1] * w
    y = torch.sum(win * taps.to(win.dtype), dim=-1)
    return X[-ntaps:].clone(), y
