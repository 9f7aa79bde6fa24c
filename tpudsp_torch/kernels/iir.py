"""Blocked first-order scan with a double-float carry (port of
``tpudsp/kernels/iir.py``: the df helpers and ``first_order_apply_blocked``),
and the AM receiver's linear tail built from two of them.

Near-unit poles (the AM DC tracker, rho = 0.9995) floor a plain f32
associative scan at ~86.5 dB. Representing the long-range carry as an
unevaluated f32 pair (hi, lo) with the Dekker/Knuth error-free transforms
below keeps ~48 mantissa bits at f32 register width.

The functions here are the plain PyTorch versions of the CUDA kernel
``csrc/first_order_scan.cu``: the same f32 operations in the same order, so
that the kernel equals them bit for bit. ``cuda/first_order`` launches the
kernel on a CUDA tensor and calls these on a CPU one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_DK = 4097.0  # 2^12 + 1: Dekker split point for f32 (24-bit mantissa)
L_BLOCK = 32  # samples per block, the JAX package's L


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _dk_split(a):
    t = _DK * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _dk_split(a)
    bh, bl = _dk_split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _df_renorm(hi, lo):
    s = hi + lo
    return s, lo - (s - hi)


def _df_add(x, y):
    sh, se = _two_sum(x[0], y[0])
    return _df_renorm(sh, se + (x[1] + y[1]))


def _df_mul(x, y):
    ph, pe = _two_prod(x[0], y[0])
    return _df_renorm(ph, pe + (x[0] * y[1] + x[1] * y[0]))


def _split64(v: float):
    """A float64 value as an f32 (hi, lo) pair."""
    hi = np.float32(v)
    return float(hi), float(np.float32(np.float64(v) - np.float64(hi)))


def block_table(b0: float, a: float, L: int = L_BLOCK) -> np.ndarray:
    """The host table of one recurrence, f32, L * L + L + 2 values: the
    within-block kernel T[i, j] = b0 a^(i-j) (j <= i, else 0) row-major,
    the entry-value powers a^(i+1), and a^L as its (hi, lo) split, all
    from float64 design values."""
    i = np.arange(L, dtype=np.float64)
    E = i[:, None] - i[None, :]
    T = np.where(E >= 0, b0 * a ** np.maximum(E, 0.0), 0.0)
    aL = _split64(np.float64(a) ** L)
    return np.concatenate([T.reshape(-1), a ** (i + 1.0), aL]).astype(np.float32)


@functools.lru_cache(maxsize=32)
def device_table(b0: float, a: float, device: torch.device, L: int = L_BLOCK):
    """``block_table`` on ``device``, made once per coefficient pair."""
    return torch.from_numpy(block_table(b0, a, L)).to(device)


def _carry(aL, y_prev, S):
    """The block entry values in double-float, in the JAX package's order
    (its lax.scan body): E[0] = (y_prev, 0), E[b+1] = a^L E[b] + (S[b], 0).
    aL: the (hi, lo) 0-d f32 pair of a^L; y_prev: (C,); S: (C, B), each
    block's last prefix value. Returns (EH, EL), each (C, B)."""
    ch = y_prev
    cl = torch.zeros_like(y_prev)
    zero = cl
    EH, EL = torch.empty_like(S), torch.empty_like(S)
    for b in range(S.shape[1]):
        EH[:, b], EL[:, b] = ch, cl
        ch, cl = _df_add(_df_mul(aL, (ch, cl)), (S[:, b], zero))
    return EH, EL


def first_order_apply_blocked(b0: float, a: float, y_prev, x,
                              L: int = L_BLOCK):
    """Blocked first-order scan: y[n] = b0 x[n] + a y[n-1], computed as the
    JAX package computes it:

    1. within each L-sample block, the inclusive prefix Yin[b, i] = sum_j
       x[bL + j] T[i, j], summed in order j = 0..L-1 (zeros included),
       multiply then add, from T = b0 a^(i-j) rounded from float64;
    2. the block entry values in double-float, one block after the other
       (``_carry``), with a^L split from float64;
    3. Y = Yin + a^(i+1) (EH + EL).

    f32 rounding stays inside one block (error ~L eps; the JAX package
    measured 123 dB at L = 32 against the f64 serial oracle at rho =
    0.9995); the carry's error (~2^-44 relative) is far below it.

    b0, a are Python floats (float64 design values). x: (n,) f32 with a 0-d
    y_prev, or C rows (C, n) with y_prev (C,). Returns (y_last, y) shaped
    like y_prev and x."""
    b0 = float(b0)
    a = float(a)
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    C = rows.shape[0]
    B = -(-n // L)
    tab = device_table(b0, a, x.device, L)
    T = tab[:L * L].reshape(L, L)
    powers = tab[L * L:L * L + L]
    aL = (tab[-2], tab[-1])
    X = torch.nn.functional.pad(rows, (0, B * L - n)).reshape(C, B, L)
    Yin = torch.zeros_like(X)
    for j in range(L):
        Yin = Yin + X[..., j:j + 1] * T[:, j]
    y_prev = torch.as_tensor(y_prev, dtype=torch.float32,
                             device=x.device).reshape(C)
    EH, EL = _carry(aL, y_prev, Yin[..., -1])
    Y = Yin + powers * (EH + EL)[..., None]
    y = Y.reshape(C, B * L)[:, :n]
    return y[:, -1].reshape(x.shape[:-1]), y.reshape(x.shape)


def linear_tail(p, dc0, de0, vr):
    """The AM receiver's linear tail over vr (n,) f32: the DC tracker (b0 =
    1 - rho, a = rho), audio = (vr - dc * use_dc) * inv_mod, then the
    de-emphasis, each a blocked scan as the JAX package's XLA back end runs
    them (the JAX Pallas back end's plain f32 associative scan floors at
    ~86.5 dB for the rho = 0.9995 DC tracker; the blocked scan keeps the
    chain above its 100 dB pin). p: kernels/am_backend.AmBackendParams
    (dc_rho, deemph_b0, deemph_a Python floats; use_dc, inv_mod 0-d f32
    tensors); dc0, de0: 0-d f32 carries. Returns ((dc_last, de_last),
    pcm)."""
    dc_last, dc_track = first_order_apply_blocked(
        1.0 - p.dc_rho, p.dc_rho, dc0, vr)
    audio = (vr - dc_track * p.use_dc) * p.inv_mod
    de_last, pcm = first_order_apply_blocked(
        p.deemph_b0, p.deemph_a, de0, audio)
    return (dc_last, de_last), pcm
