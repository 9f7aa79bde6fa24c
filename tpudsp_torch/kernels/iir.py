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


def _split(v):
    """float64 values as their f32 (hi, lo) split."""
    v = np.asarray(v, np.float64)
    hi = v.astype(np.float32)
    return hi, (v - hi).astype(np.float32)


def _split64(v: float):
    """A float64 value as an f32 (hi, lo) pair."""
    hi = np.float32(v)
    return float(hi), float(np.float32(np.float64(v) - np.float64(hi)))


TILE_BLOCKS = 256  # blocks of L in one tile of the carry scan (the kernel's threads)
COLS_TILE_BLOCKS = 32    # the same in a tile of the column entry (first_order_scan_cols)
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
    hi, lo = _split(np.float64(a) ** (L * np.arange(tb + 1, dtype=np.float64)))
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
    order, operation for operation. powers: the (hi, lo) pair of the f32
    block powers a^(L m), m = 0..tb or more; y_prev: (C,); S: (C, B),
    each block's last prefix value. Returns (EH, EL), each (C, B)."""
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
                              L: int = L_BLOCK, tb: int = TILE_BLOCKS):
    """Blocked first-order scan: y[n] = b0 x[n] + a y[n-1], computed as the
    JAX package computes it, with the block carry as a log-depth scan:

    1. within each L-sample block, the inclusive prefix Yin[b, i] = sum_j
       x[bL + j] T[i, j], summed in order j = 0..L-1 (zeros included),
       multiply then add, from T = b0 a^(i-j) rounded from float64;
    2. the block entry values in double-float (``_carry``: a log-depth
       scan within tiles of ``tb`` blocks, 256 for the rows entry, one step
       from tile to tile), with the powers a^(L m) split from float64;
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
    EH, EL = _carry((pairs[:, 0], pairs[:, 1]), y_prev, Yin[..., -1], tb)
    Y = Yin + powers * (EH + EL)[..., None]
    y = Y.reshape(C, B * L)[:, :n]
    return y[:, -1].reshape(x.shape[:-1]), y.reshape(x.shape)


def first_order_apply_blocked_mc(b0: float, a: float, y_prev, x):
    """The column twin of ``first_order_apply_blocked`` (the JAX package's
    ``tpudsp/kernels/iir.py`` ``first_order_apply_blocked_mc``): the same
    recurrence y[n, c] = b0 x[n, c] + a y[n-1, c] down axis 0 of a
    row-major (N, C) f32 frame matrix, the polyphase channelizer's layout.
    Computed as the rows version computes each of x's columns at tiles of
    COLS_TILE_BLOCKS blocks (the plain version of csrc/first_order_scan.cu's
    column entry, first_order_scan_cols, bit for bit), where the JAX
    package forms its (L, L) kernel from f32 powers. y_prev: (C,). Returns
    (y_last (C,), y (N, C))."""
    last, y = first_order_apply_blocked(b0, a, y_prev, x.T, tb=COLS_TILE_BLOCKS)
    return last, y.T


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


def first_order_apply_blocked_c64(b0: float, a: float, y_prev, x):
    """The complex one-pole y[n] = b0 x[n] + a y[n-1] over x (n,) complex64
    with a complex64 y_prev: b0 and a are real, so the re and im parts are
    two rows of ``first_order_apply_blocked`` (the plain version of
    csrc/first_order_scan.cu's complex64 entry, which reads them in the
    interleaved layout). The JAX twin (``tpudsp/kernels/iir.py``
    ``first_order_apply_blocked_c64``) carries its block entries as plain
    complex64; these carry in double-float. Returns (y_last, y)."""
    y_prev = torch.as_tensor(y_prev, dtype=torch.complex64, device=x.device)
    last, y = first_order_apply_blocked(b0, a, torch.view_as_real(y_prev.reshape(1))[0],
                                        torch.view_as_real(x).T)
    return torch.complex(last[0], last[1]), torch.complex(y[0], y[1])


# --- the compensated SOS cascade (tpudsp/kernels/iir.py sos_apply_df), as
# csrc/biquad_scan.cu runs it
#
# Transposed direct form II per biquad (b0, b1, b2, 1, a1, a2) as the state
# recurrence v[n] = A v[n-1] + c x[n], A = [[-a1, 1], [-a2, 0]], c = [b1 -
# a1 b0, b2 - a2 b0], y[n] = b0 x[n] + v[n-1][0], every value of v a
# double-float pair. Per section:
#   1. each block of SOS_L samples runs from a zero entry, keeping its
#      local states v_loc[i]; its last is S[b], the constant of the
#      block's affine map v -> A^L v + S[b];
#   2. a log-depth scan of the S[b] within each tile of SOS_TB blocks; the
#      tile's last value is its aggregate P_t (its map v -> A^T v + P_t);
#   3. windows of SOS_WINDOW tiles: tile j of a window folds the
#      aggregates of the tiles before it in the window in a fixed order
#      (``_window_fold``), F_j = sum_{k<j} A^(T (j-1-k)) P_k, and takes
#      E_t = A^(T j) E_w + F_j from the window's entry E_w; the window's
#      last tile hands the next window E_w' = A^T E_t + P_t, from E_0 =
#      (v_prev, 0);
#   4. the block entries E[0] = E_t, E[b] = A^(L b) E_t + P[b-1]; then each
#      sample's state without a second pass, v[i] = A^(i+1) E[b] +
#      v_loc[i]: y[i] = b0 x[i] + v[i-1][0] needs only row 0 of A^i, and
#      the whole state is made at the row's last sample only.
# The powers come from float64, split by the host (``sos_table``). Every
# product's error term is the exact one, as a fused multiply-add gives it
# (``_prod``), where the JAX package's Dekker split gives the same value
# wherever neither factor's split underflows.

SOS_L = 16              # samples a block: one thread's chain
SOS_TB = 128            # blocks a tile: the kernel's threads
SOS_TILE = SOS_L * SOS_TB
SOS_WINDOW = SOS_TB     # tiles a fold window: one a thread of the kernel
SOS_HEAD = 16           # a section's coefficients in its table row
# a section's powers, in this order: A^(L m) for m = 0..SOS_TB-1, A^k for
# k = 1..SOS_L, A^(SOS_TILE m) for m = 0..SOS_WINDOW-1
SOS_NPOW = SOS_TB + SOS_L + SOS_WINDOW
SOS_SAMPLE_POW = SOS_TB - 1              # A^k at SOS_SAMPLE_POW + k
SOS_TILE_POW = SOS_TB + SOS_L            # A^(T m) at SOS_TILE_POW + m
SOS_WIDTH = SOS_HEAD + 8 * SOS_NPOW


def sos_init(sos: np.ndarray, dtype=torch.float32, device=None):
    """Zero state for an SOS cascade: (S, 2) per-biquad DF2T state."""
    return torch.zeros((len(sos), 2), dtype=dtype, device=device)


def sos_split_df(sos64: np.ndarray):
    """float64 SOS (S, 6) -> the double-float scan coefficients, split
    before any f32 rounding (for low-Fc high-Q designs the f32-rounded a1,
    a2 move the poles by enough to change the filter): (A_hi, A_lo (S, 2,
    2), c_hi, c_lo (S, 2), b0 (S,)), f32 numpy arrays, as the JAX
    package's sos_split_df."""
    sos64 = np.asarray(sos64, np.float64)
    b0, b1, b2, _, a1, a2 = sos64.T
    one, zero = np.ones_like(a1), np.zeros_like(a1)
    A64 = np.stack([np.stack([-a1, one], -1), np.stack([-a2, zero], -1)], -2)
    c64 = np.stack([b1 - a1 * b0, b2 - a2 * b0], -1)
    return (*_split(A64), *_split(c64), b0.astype(np.float32))


def sos_powers(a1: float, a2: float) -> np.ndarray:
    """A section's powers of A = [[-a1, 1], [-a2, 0]] in float64, (SOS_NPOW,
    2, 2), in the table's order (see SOS_NPOW), each by
    numpy.linalg.matrix_power."""
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    ks = [*(SOS_L * m for m in range(SOS_TB)), *range(1, SOS_L + 1),
          *(SOS_TILE * m for m in range(SOS_WINDOW))]
    return np.stack([np.linalg.matrix_power(A, k) for k in ks])


def sos_table(sos64: np.ndarray) -> np.ndarray:
    """The host table of an SOS cascade, (S, SOS_WIDTH) f32: per section
    -a1, -a2, c0, c1 as (hi, lo) pairs and b0 (``sos_split_df``'s values),
    zeros to SOS_HEAD, then ``sos_powers`` split as 8 arrays of SOS_NPOW
    (entries [0, 0], [0, 1], [1, 0], [1, 1], each hi then lo)."""
    A_hi, A_lo, c_hi, c_lo, b0 = sos_split_df(sos64)
    sos64 = np.asarray(sos64, np.float64)
    tab = np.zeros((len(sos64), SOS_WIDTH), np.float32)
    for s, (_, _, _, _, a1, a2) in enumerate(sos64):
        tab[s, :9] = [A_hi[s, 0, 0], A_lo[s, 0, 0], A_hi[s, 1, 0], A_lo[s, 1, 0],
                      c_hi[s, 0], c_lo[s, 0], c_hi[s, 1], c_lo[s, 1], b0[s]]
        hi, lo = _split(sos_powers(a1, a2).reshape(SOS_NPOW, 4).T)
        tab[s, SOS_HEAD:] = np.stack([hi, lo], 1).reshape(-1)
    return tab


def _prod(a, b):
    """The exact product a b = p + e of f32 tensors, e as one fused
    multiply-add rounds it (the kernel's __fmaf_rn(a, b, -p)): a b is
    exact in float64, so is a b - p, and the f32 cast rounds it once."""
    p = a * b
    return p, (a.double() * b.double() - p.double()).float()


def _dmul(x, y):
    """``_df_mul`` with the product by ``_prod``."""
    ph, pe = _prod(x[0], y[0])
    return _df_renorm(ph, pe + (x[0] * y[1] + x[1] * y[0]))


def _mul(M, p):
    """M p in double-float: M a 2x2 matrix as its entries (a, b, c, d), p a
    2-vector, each value a (hi, lo) pair."""
    a, b, c, d = M
    return (_df_add(_dmul(a, p[0]), _dmul(b, p[1])),
            _df_add(_dmul(c, p[0]), _dmul(d, p[1])))


def _add(p, q):
    return _df_add(p[0], q[0]), _df_add(p[1], q[1])


def _mv(M, p, q):
    """M p + q in double-float."""
    return _add(_mul(M, p), q)


def _vmap(fn, *vs):
    """fn over the four tensors of each 2-vector of (hi, lo) pairs."""
    return tuple(tuple(fn(*parts) for parts in zip(*pairs)) for pairs in zip(*vs))


def _biquad_step(co, v, x):
    """One double-float step v <- A v + c x of a section; co = (-a1, -a2,
    c0, c1) as (hi, lo) pairs."""
    m00, m10, c0, c1 = co
    u0 = _prod(c0[0], x)
    u0 = _df_renorm(u0[0], u0[1] + c0[1] * x)
    u1 = _prod(c1[0], x)
    u1 = _df_renorm(u1[0], u1[1] + c1[1] * x)
    return (_df_add(_dmul(m00, v[0]), _df_add(v[1], u0)),
            _df_add(_dmul(m10, v[0]), u1))


def _biquad_tile_scan(power, S, run: int = WARP):
    """The inclusive scan of the block constants S (a 2-vector of (...,
    tb) pairs) within each tile, with ``power(m)``, the matrix A^(L m), as
    the kernel's warps run it: Kogge-Stone within each run of ``run``
    blocks; the scan of the runs' last values T_r in order, C_0 = T_0, C_r
    = A^(L run) C_(r-1) + T_r; then each block of run r > 0 adds A^(L
    (l+1)) C_(r-1) (l: its place in the run)."""
    shape = S[0][0].shape
    p = _vmap(lambda t: t.reshape(*shape[:-1], shape[-1] // run, run), S)
    d = 1
    while d < run:
        q = _vmap(lambda t: t[..., :-d], p)
        new = _mv(power(d), q, _vmap(lambda t: t[..., d:], p))
        p = _vmap(lambda t, u: torch.cat([t[..., :d], u], -1), p, new)
        d *= 2
    c = [_vmap(lambda t: t[..., 0, -1], p)]
    for r in range(1, shape[-1] // run - 1):
        c.append(_mv(power(run), c[-1], _vmap(lambda t: t[..., r, -1], p)))
    w = _vmap(lambda *ts: torch.stack(ts, -1), *c)
    lane = torch.arange(1, run + 1, device=S[0][0].device)
    c = _mv(power(lane), _vmap(lambda t: t[..., None], w), _vmap(lambda t: t[..., 1:, :], p))
    return _vmap(lambda t, u: torch.cat([t[..., :1, :], u], -2).reshape(shape), p, c)


def _window_fold(power, Pt, run: int = WARP):
    """The fold of step 3 for every tile: F_j = sum_{k<j} A^(T (j-1-k))
    P_k over the tiles k of its window, in the kernel's order: its thread
    k makes term k (0 for k >= j); each warp adds its run of 32 in the tree
    of its shuffles (at d = 16, 8, 4, 2, 1 lane l < d takes its value +
    lane l + d's); thread 0 adds the warps' sums in order, ((w0 + w1) +
    w2) + .... ``power(m)``: A^(T m); Pt: the aggregates, (R, windows, W)
    pairs. Returns F, (R, windows, W) pairs."""
    W = SOS_WINDOW
    j = torch.arange(W, device=Pt[0][0].device)
    m = j[:, None] - 1 - j[None, :]                 # (tile j, thread k)
    terms = _mul(power(m.clamp(min=0)), _vmap(lambda t: t[..., None, :], Pt))
    terms = _vmap(lambda t: torch.where(m >= 0, t, torch.zeros_like(t))
                  .reshape(*t.shape[:-1], W // run, run), terms)
    d = run // 2
    while d:
        terms = _add(_vmap(lambda t: t[..., :d], terms), _vmap(lambda t: t[..., d:2 * d], terms))
        d //= 2
    f = _vmap(lambda t: t[..., 0, 0], terms)
    for w in range(1, W // run):
        f = _add(f, _vmap(lambda t: t[..., w, 0], terms))
    return f


def _biquad_rows(tab, v0, X):
    """One section over the rows X (R, n) f32 from the f32 states v0 (2,
    R), as the kernel runs it. Returns (v_last (2, R), y (R, n))."""
    L, tb, W, T = SOS_L, SOS_TB, SOS_WINDOW, SOS_TILE
    R, n = X.shape
    nt = -(-n // T)
    nw = -(-nt // W)
    dev = X.device
    Xb = torch.nn.functional.pad(X, (0, nt * T - n)).reshape(R, nt, tb, L)
    co = tuple((tab[2 * k], tab[2 * k + 1]) for k in range(4))
    b0 = tab[8]
    pw = tab[SOS_HEAD:].reshape(8, SOS_NPOW)

    def power(m):
        return tuple((pw[2 * e, m], pw[2 * e + 1, m]) for e in range(4))

    # 1. each block from a zero entry: v_loc[i][0] of every sample, and the
    # whole state at the row's last sample
    zero = torch.zeros_like(Xb[..., 0])
    v = ((zero, zero), (zero, zero))
    loc = []
    last_i = (n - 1) % L
    for i in range(L):
        v = _biquad_step(co, v, Xb[..., i])
        loc.append(v[0])
        if i == last_i:
            v_end = v
    # 2. the scan within each tile
    P = _biquad_tile_scan(power, v)
    # 3. the fold within each window and the windows' chain of entries
    Pt = _vmap(lambda t: torch.nn.functional.pad(t[..., -1], (0, nw * W - nt))
               .reshape(R, nw, W), P)
    F = _window_fold(lambda m: power(SOS_TILE_POW + m), Pt)
    e = ((v0[0], torch.zeros_like(v0[0])), (v0[1], torch.zeros_like(v0[1])))
    tile_pow = power(SOS_TILE_POW + torch.arange(W, device=dev))
    Et = []
    for w in range(nw):
        Ew = _mv(tile_pow, _vmap(lambda t: t[:, None], e), _vmap(lambda t: t[:, w], F))
        Et.append(Ew)
        if w + 1 < nw:
            e = _mv(power(SOS_TILE_POW + 1), _vmap(lambda t: t[:, -1], Ew),
                    _vmap(lambda t: t[:, w, -1], Pt))
    Et = _vmap(lambda *ts: torch.cat(ts, 1)[:, :nt, None], *Et)
    # 4. the block entries, then each sample from its block's entry
    rest = _mv(power(torch.arange(1, tb, device=dev)), Et, _vmap(lambda t: t[..., :-1], P))
    E = _vmap(lambda t, u: torch.cat([t, u], -1), Et, rest)
    Y = torch.empty_like(Xb)
    Y[..., 0] = b0 * Xb[..., 0] + (E[0][0] + E[0][1])
    for i in range(1, L):
        a, b, _, _ = power(SOS_SAMPLE_POW + i)
        prev = _df_add(_df_add(_dmul(a, E[0]), _dmul(b, E[1])), loc[i - 1])
        Y[..., i] = b0 * Xb[..., i] + (prev[0] + prev[1])
    blk = (n - 1) // L
    at = lambda t: t.reshape(R, nt * tb)[:, blk]
    vl = _mv(power(SOS_SAMPLE_POW + last_i + 1), _vmap(at, E), _vmap(at, v_end))
    return torch.stack([vl[0][0] + vl[0][1], vl[1][0] + vl[1][1]]), Y.reshape(R, -1)[:, :n]


def sos_apply_df(tab, state, x):
    """The compensated SOS cascade over a 1-D block, as csrc/biquad_scan.cu
    runs it (its plain version: the same f32 operations in the same order).
    tab: ``sos_table``'s (S, SOS_WIDTH) f32 table as a tensor; state: (S,
    2) f32, or complex64 for complex x; x: (N,) f32 or complex64 (its re
    and im parts run as two rows). Sections run one after the other.
    Returns (new_state, y); the state carried from call to call is f32
    (hi + lo), as in the JAX package."""
    if x.shape[0] == 0:
        return state, x
    cplx = x.is_complex()
    X = torch.view_as_real(x).T if cplx else x[None]
    # (S, 2, R): R = 1 real row, or the re and im rows of a complex state
    V = torch.view_as_real(state) if cplx else state[..., None]
    last = []
    for s in range(tab.shape[0]):
        v, X = _biquad_rows(tab[s], V[s], X)
        last.append(v)
    V = torch.stack(last)
    if cplx:
        return torch.complex(V[..., 0], V[..., 1]), torch.complex(X[0], X[1])
    return V[..., 0], X[0]
