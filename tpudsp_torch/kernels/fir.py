"""Block FIR with carried overlap state and the delay line (port of
``tpudsp/kernels/fir.py``).

y[n] = sum_k h[k] x[n-k] over the concatenated stream: the carried state is
the last (ntaps-1) inputs. Short filters (<= DIRECT_TAPS_MAX taps) run as a
sum of shifted scalings, long ones as overlap-save FFT segments with
``torch.fft`` -- the JAX package's two methods with its segment size
F = max(next_pow2(2K), 4096) and hop F - (K-1), so the two round alike.
Both are plain tensor code, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

# direct conv below this tap count; overlap-save FFT above
DIRECT_TAPS_MAX = 96


def fir_init(ntaps: int, dtype=torch.float32, device=None):
    """Zero tail state: the last (ntaps-1) inputs."""
    return torch.zeros((max(ntaps - 1, 0),), dtype=dtype, device=device)


def _next_pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def _zpad(x, n: int):
    """x with n zeros appended."""
    return torch.cat([x, x.new_zeros((n,))]) if n > 0 else x


def _conv_valid_direct(X, h):
    """Valid-mode convolution: out[n] = sum_k h[k] X[n + K-1 - k]."""
    K = h.shape[0]
    N = X.shape[0] - K + 1
    acc = torch.zeros((N,), dtype=torch.result_type(X, h), device=X.device)
    for k in range(K):
        acc = acc + h[k] * X[K - 1 - k: K - 1 - k + N]
    return acc


def _conv_valid_fft(X, h):
    """Overlap-save FFT valid convolution. X: (K-1+N,), h: (K,)."""
    K = h.shape[0]
    N = X.shape[0] - K + 1
    F = max(_next_pow2(2 * K), 4096)
    hop = F - (K - 1)
    nseg = -(-N // hop)
    # segment s reads Xp[s*hop : s*hop + F): hop-row s and the first K-1
    # samples of row s+1
    Xp = _zpad(X, (nseg + 1) * hop - X.shape[0])
    A = Xp.reshape(nseg + 1, hop)
    segs = torch.cat([A[:-1], A[1:, : K - 1]], dim=1)
    Hf = torch.fft.fft(h.to(torch.complex64), n=F)
    Sf = torch.fft.fft(segs.to(torch.complex64), dim=-1)
    y = torch.fft.ifft(Sf * Hf[None, :], dim=-1)[:, K - 1:]
    y = y.reshape(-1)[:N]
    if not (X.is_complex() or h.is_complex()):
        y = y.real
    return y.to(torch.result_type(X, h))


def fir_apply(h, tail, x, method: str = "auto"):
    """Apply FIR taps ``h`` to block ``x`` with carried tail state.

    h: (K,) float32; tail: (K-1,); x: (N,) float32 or complex64. Returns
    (new_tail, y) with y[n] = sum_k h[k] x_full[n-k] where x_full is the
    concatenated stream."""
    K = h.shape[0]
    if K == 1:
        return tail, h[0] * x
    X = torch.cat([tail.to(x.dtype), x])
    if method == "direct" or (method == "auto" and K <= DIRECT_TAPS_MAX):
        y = _conv_valid_direct(X, h)
    else:
        y = _conv_valid_fft(X, h)
    return X[-(K - 1):].clone(), y


def delay_init(nd: int, dtype=torch.float32, device=None):
    """Zero state for an nd-sample delay line (read-before-push)."""
    return torch.zeros((nd,), dtype=dtype, device=device)


def delay_apply(buf, x):
    """nd-sample delay: emits the buffered samples first. Returns
    (new_buf, y) with y[n] = x_full[n - nd]."""
    nd = buf.shape[0]
    if nd == 0:
        return buf, x
    X = torch.cat([buf.to(x.dtype), x])
    return X[-nd:].clone(), X[: x.shape[0]]
