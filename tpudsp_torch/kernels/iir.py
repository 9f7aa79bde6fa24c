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


TILE_BLOCKS = 256  # blocks of L in one tile of the carry scan (the kernel's threads)
WARP = 32          # blocks of a tile in one run of the scan (the kernel's warp)
TABLE_SIZE = L_BLOCK * L_BLOCK + L_BLOCK + 2 * (TILE_BLOCKS + 1)


def block_table(b0: float, a: float, L: int = L_BLOCK,
                tb: int = TILE_BLOCKS) -> np.ndarray:
    """The host table of one recurrence, f32, L * L + L + 2 (tb + 1)
    values: the within-block kernel T[i, j] = b0 a^(i-j) (j <= i, else 0)
    row-major, the entry-value powers a^(i+1), and the block powers
    a^(L m) for m = 0..tb, each as its (hi, lo) split, all from float64
    design values."""
    i = np.arange(L, dtype=np.float64)
    E = i[:, None] - i[None, :]
    T = np.where(E >= 0, b0 * a ** np.maximum(E, 0.0), 0.0)
    P = np.float64(a) ** (L * np.arange(tb + 1, dtype=np.float64))
    hi = P.astype(np.float32)
    lo = (P - hi.astype(np.float64)).astype(np.float32)
    return np.concatenate([T.reshape(-1), a ** (i + 1.0),
                           np.stack([hi, lo], 1).reshape(-1)]).astype(np.float32)


@functools.lru_cache(maxsize=32)
def device_table(b0: float, a: float, device: torch.device, L: int = L_BLOCK):
    """``block_table`` on ``device``, made once per coefficient pair."""
    return torch.from_numpy(block_table(b0, a, L)).to(device)


def _scan_levels(MH, ML, ph, pl, stride: int = 1):
    """Kogge-Stone over the last axis in double-float: P[b] <- a^(L d
    stride) P[b-d] + P[b] for b >= d at d = 1, 2, ..., from (ph, pl)."""
    d = 1
    while d < ph.shape[-1]:
        nh, nl = _df_add(_df_mul((MH[d * stride], ML[d * stride]), (ph[..., :-d], pl[..., :-d])),
                         (ph[..., d:], pl[..., d:]))
        ph = torch.cat([ph[..., :d], nh], -1)
        pl = torch.cat([pl[..., :d], nl], -1)
        d *= 2
    return ph, pl


def _tile_scan(MH, ML, S, run: int = WARP):
    """The inclusive scan of the block sums within each tile, in
    double-float, log-depth, as the kernel's warps run it: Kogge-Stone
    within each run of ``run`` blocks, then over the runs' last values,
    then each block of run r > 0 adds a^(L (l+1)) times the scan of the
    runs before it (l: its place in the run). MH, ML: the (tb + 1,) block
    powers a^(L m); S: (..., tb). Returns (PH, PL)."""
    shape = S.shape
    Sr = S.reshape(*shape[:-1], shape[-1] // run, run)
    ph, pl = _scan_levels(MH, ML, Sr, torch.zeros_like(Sr))
    th, tl = _scan_levels(MH, ML, ph[..., -1], pl[..., -1], run)
    ch, cl = _df_add(_df_mul((MH[1:run + 1], ML[1:run + 1]),
                             (th[..., :-1, None], tl[..., :-1, None])),
                     (ph[..., 1:, :], pl[..., 1:, :]))
    return (torch.cat([ph[..., :1, :], ch], -2).reshape(shape),
            torch.cat([pl[..., :1, :], cl], -2).reshape(shape))


def _carry(powers, y_prev, S, tb: int = TILE_BLOCKS):
    """The block entry values in double-float, tile by tile: within a tile
    of tb blocks, P = ``_tile_scan`` of the block sums and, from the
    tile's entry E_t, E[0] = E_t, E[b] = a^(L b) E_t + P[b-1]; the next
    tile's entry is a^(L tb) E_t + P[tb-1], E_0 = (y_prev, 0). The kernel's
    order, operation for operation. powers: the (hi, lo) pair of (tb + 1,)
    f32 block powers a^(L m); y_prev: (C,); S: (C, B), each block's last
    prefix value. Returns (EH, EL), each (C, B)."""
    MH, ML = powers
    C, B = S.shape
    nt = -(-B // tb)
    S = torch.nn.functional.pad(S, (0, nt * tb - B)).reshape(C, nt, tb)
    PH, PL = _tile_scan(MH, ML, S)
    EH, EL = torch.empty_like(S), torch.empty_like(S)
    eh, el = y_prev, torch.zeros_like(y_prev)
    for t in range(nt):
        EH[:, t, 0], EL[:, t, 0] = eh, el
        EH[:, t, 1:], EL[:, t, 1:] = _df_add(
            _df_mul((MH[1:tb], ML[1:tb]), (eh[:, None], el[:, None])),
            (PH[:, t, :-1], PL[:, t, :-1]))
        eh, el = _df_add(_df_mul((MH[tb], ML[tb]), (eh, el)),
                         (PH[:, t, -1], PL[:, t, -1]))
    return EH.reshape(C, -1)[:, :B], EL.reshape(C, -1)[:, :B]


def first_order_apply_blocked(b0: float, a: float, y_prev, x,
                              L: int = L_BLOCK):
    """Blocked first-order scan: y[n] = b0 x[n] + a y[n-1], computed as the
    JAX package computes it, with the block carry as a log-depth scan:

    1. within each L-sample block, the inclusive prefix Yin[b, i] = sum_j
       x[bL + j] T[i, j], summed in order j = 0..L-1 (zeros included),
       multiply then add, from T = b0 a^(i-j) rounded from float64;
    2. the block entry values in double-float (``_carry``: a log-depth
       scan within tiles of 256 blocks, one step from tile to tile), with
       the powers a^(L m) split from float64;
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
    pairs = tab[L * L + L:].reshape(-1, 2)
    X = torch.nn.functional.pad(rows, (0, B * L - n)).reshape(C, B, L)
    Yin = torch.zeros_like(X)
    for j in range(L):
        Yin = Yin + X[..., j:j + 1] * T[:, j]
    y_prev = torch.as_tensor(y_prev, dtype=torch.float32,
                             device=x.device).reshape(C)
    EH, EL = _carry((pairs[:, 0], pairs[:, 1]), y_prev, Yin[..., -1])
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
