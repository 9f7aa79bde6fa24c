"""Fused filter + decimate front end as one strided matmul (port of the
shared-grid path of ``tpudsp/kernels/decimate.py``), and the bank's
wide strided complex FIR (``strided_cfir_matmul_wide*``, at the end).

The fused AM front end evaluates the bandpass folded into the polyphase
resampler only at the output points: y_r[j] = sum_i X[off_r + j*Q + i]
taps_r[i], stride Q, P phases. With the per-phase offsets folded into
left-zero-padded taps (``fold_offsets``), every phase shares one frame
grid, and the whole front end is

    Xm  = X[: M*Q].reshape(M, Q)                       (M, Q) frames
    Z   = Xm @ T.reshape(P*Kc2, Q)^T                   (M, P, Kc2)
    y[j, r] = sum_c Z[j + c, r, c]                     diagonal sum

The JAX package leaves this product to XLA outside any Pallas kernel, so
the port leaves it to ``torch.matmul`` in full f32 (TF32 off), and the
diagonal sum is one strided view summed over its last axis. Raw i16 and
u8 wire input is converted to f32 on operand load; the i16 1/32767 and
u8 1/127.5 scales ride the taps (``chains/am.build``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import f32_conv1d, f32_matmul


def plan_phase_taps(taps_per_phase: np.ndarray, Q: int):
    """Host-side: (P, Kf) per-phase taps -> (P, Kc, Q) blocked/padded."""
    P, Kf = taps_per_phase.shape
    Kc = -(-Kf // Q)
    T = np.zeros((P, Kc * Q), taps_per_phase.dtype)
    T[:, :Kf] = taps_per_phase
    return T.reshape(P, Kc, Q)


def plan_fused_frontend(H_bank: np.ndarray, h_lti: np.ndarray, P: int, Q: int):
    """Fold an LTI filter (taps at the input rate) into the P polyphase
    rows a rational-rate (P/Q) decimator needs, blocked for the matmul.

    The combined correlation taps for phase r are
    d_r = conv(bank_row_r, reverse(h_lti)); output k = j*P + r reads the
    window starting at X index j*Q + floor(r*Q/P), where X carries a
    kf = len(h_lti) + 2m - 1 sample tail.

    Returns (taps_blocked (P, Kc, Q) float32, kf, offsets)."""
    npfb = H_bank.shape[0] - 1
    rows = []
    for r in range(P):
        f_r = (r * Q / P) % 1.0
        fb = f_r * npfb
        b = int(np.floor(fb))
        w = fb - b
        bank = (1 - w) * H_bank[b] + w * H_bank[b + 1]
        rows.append(np.convolve(bank, h_lti[::-1]))
    taps = plan_phase_taps(np.stack(rows).astype(np.float32), Q)
    kf = len(h_lti) + H_bank.shape[1] - 1
    offsets = [(r * Q) // P for r in range(P)]
    return taps, kf, offsets


def fold_offsets(taps, offsets, Q: int):
    """Fold per-phase window offsets into left-zero-padded taps so every
    phase shares the stride-Q window grid starting at j*Q: taps'[r][i] =
    taps[r][i - off_r]. taps: (P, Kc, Q); returns (P, Kc2, Q)."""
    P, Kc, Q_ = taps.shape
    flat = np.asarray(taps).reshape(P, Kc * Q_)
    kc2 = -(-(max(offsets) + flat.shape[1]) // Q)
    out = np.zeros((P, kc2 * Q), np.float32)
    for r, off in enumerate(offsets):
        out[r, off:off + flat.shape[1]] = flat[r]
    return out.reshape(P, kc2, Q)


def _shared_grid_matmul(Xm, T, nj: int):
    """Xm: (S, M, Q) f32 frames (S planes: re and im); T: (P, Kc2, Q)
    offset-folded taps. Returns (S, nj, P) outputs in frame order (output
    k = j*P + r at [s, j, r])."""
    P, Kc2, Q = T.shape
    S, M, _ = Xm.shape
    Z = f32_matmul(Xm, T.reshape(P * Kc2, Q).T).contiguous()  # (S, M, P*Kc2)
    # diagonal [s, j, r, c] -> Z[s, j + c, r, c]: stride P*Kc2 + 1 along c
    D = Z.as_strided((S, nj, P, Kc2), (M * P * Kc2, P * Kc2, Kc2, P * Kc2 + 1))
    return D.sum(-1)


def _apply_shared(taps, tail, iq, pad_value, Q: int, nj: int, dc=None):
    """The one-pass front end over [tail, iq, pad]: returns (new_tail,
    y (nj*P,) complex64). Complex input is read as its (re, im) f32 view;
    (N, 2) integer wire input is converted to f32 frame by frame."""
    P, Kc2, _ = taps.shape
    kf, N = tail.shape[0], iq.shape[0]
    M = nj + Kc2 - 1
    padding = torch.full(((Kc2 + 1) * Q,) + tuple(iq.shape[1:]), pad_value,
                         dtype=iq.dtype, device=iq.device)
    X = torch.cat([tail, iq, padding])
    F = X[: M * Q]
    F = torch.view_as_real(F) if F.is_complex() else F.float()
    out = _shared_grid_matmul(F.reshape(M, Q, 2).permute(2, 0, 1), taps, nj)
    if dc is not None:
        out = out - dc
    y = torch.complex(out[0], out[1]).reshape(-1)
    return X[N:N + kf].clone(), y


def fused_frontend_apply_shared(taps, tail, iq, Q: int, nj: int):
    """taps: (P, Kc2, Q) from fold_offsets; tail: (kf,) complex64; iq: (N,)
    complex64. Returns (new_tail, y (nj*P,) complex64)."""
    return _apply_shared(taps, tail, iq, 0, Q, nj)


def fused_frontend_apply_shared_i16(taps, tail, iq2, Q: int, nj: int):
    """Raw-int16 twin: taps carry the 1/32767 scale; tail/iq2 are (.., 2)
    int16 [re, im]."""
    return _apply_shared(taps, tail, iq2, 0, Q, nj)


def fused_frontend_apply_shared_u8(taps, dc, tail, iq2, Q: int, nj: int):
    """RTL-SDR wire format: (N, 2) uint8 with sample value (b-127.5)/127.5.
    The affine conversion folds into the matmul: taps carry the 1/127.5
    scale and ``dc`` (P,) is the per-phase original-tap sum, subtracted
    from both the re and the im output. The pad value is irrelevant
    (windows only overlap the pad where the folded taps are zero); the
    tail starts at 127, within half an LSB of zero signal."""
    return _apply_shared(taps, tail, iq2, 127, Q, nj, dc=dc)


# --------------------------------------------------------------------------
# The strided complex decimating FIR of the receiver bank as ONE wide real
# matmul (port of ``strided_cfir_matmul_wide{,_i16,_u8}``): the Kc shifted
# frame slices form explicit windows (one strided view of the input), and
# the complex product is packed into one real product
#
#     W  = [wr | wi]                      (nj, 2*K1)   K1 = Kc*Q
#     TT = [[Tr, Ti], [-Ti, Tr]]          (2*K1, 2*C)
#     [yr | yi] = W @ TT                  (nj, 2*C)
#
# y[c, j] = sum_k X[j*Q + k] T_c[k]. These are the plain versions the
# async-halo kernel (csrc/halo_async.cu) is held against, in full f32.

def _wide(xr, xi, Tre, Tim, Q: int, nj: int):
    """(L,) f32 planes with L >= (nj + Kc - 1) * Q -> Y (nj, 2C) f32."""
    C, Kc, Q_ = Tre.shape
    K1 = Kc * Q_
    L = (nj + Kc - 1) * Q_
    W = torch.cat([xr[:L].unfold(0, K1, Q_), xi[:L].unfold(0, K1, Q_)], 1)
    Tr = Tre.reshape(C, K1).T
    Ti = Tim.reshape(C, K1).T
    TT = torch.cat([torch.cat([Tr, Ti], 1), torch.cat([-Ti, Tr], 1)], 0)
    return f32_matmul(W, TT)


def _complex_cols(yr, yi):
    """(nj, C) re and im columns -> (C, nj) complex64."""
    return torch.complex(yr.T, yi.T).contiguous()


def strided_cfir_matmul_wide(X, Tre, Tim, Q: int, nj: int):
    """X: (L,) complex64; Tre/Tim: (C, Kc, Q) blocked correlation-order
    taps. Returns (C, nj) complex64."""
    C = Tre.shape[0]
    Xr = torch.view_as_real(X.to(torch.complex64))
    Y = _wide(Xr[:, 0], Xr[:, 1], Tre, Tim, Q, nj)
    return _complex_cols(Y[:, :C], Y[:, C:])


def strided_cfir_matmul_wide_i16(X2, Tre, Tim, Q: int, nj: int):
    """Raw interleaved int16 input: X2 is (L, 2) int16 [re, im] and
    Tre/Tim carry the 1/32767 scale pre-folded. Returns (C, nj)
    complex64."""
    C = Tre.shape[0]
    Y = _wide(X2[:, 0].float(), X2[:, 1].float(), Tre, Tim, Q, nj)
    return _complex_cols(Y[:, :C], Y[:, C:])


def strided_cfir_matmul_wide_u8(X2, Tre, Tim, Q: int, nj: int):
    """RTL-SDR uint8 input: X2 is (L, 2) uint8 [re, im] with sample value
    (b - 127.5)/127.5. Tre/Tim carry the 1/127.5 scale; the -127.5 offset
    becomes a per-channel complex DC term from the tap sums, subtracted
    from the packed outputs. Returns (C, nj) complex64."""
    C = Tre.shape[0]
    Y = _wide(X2[:, 0].float(), X2[:, 1].float(), Tre, Tim, Q, nj)
    sre = 127.5 * Tre.reshape(C, -1).sum(1)
    sim = 127.5 * Tim.reshape(C, -1).sum(1)
    return _complex_cols(Y[:, :C] - (sre - sim), Y[:, C:] - (sre + sim))


# --------------------------------------------------------------------------
# The JAX package's CPU form of the bank front end (port of
# ``_cfir_conv_core`` and ``strided_cfir_conv{,_i16,_u8}``): the same
# y[c, j] = sum_k X[j*Q + k] T_c[k] as the wide matmul above, as one strided
# convolution. The bank runs the CUDA kernel csrc/halo_async.cu
# (``cuda/halo_async.cfir``); these forms are what it is held against.


def _cfir_conv_core(xr, xi, Tre, Tim, Q: int, nj: int):
    """xr/xi: (L,) f32 input planes with L >= (nj + Kc - 1) * Q. The
    complex product packed as 2C real output features of one strided
    convolution (f32, TF32 off): y_r = xr*tr - xi*ti, y_i = xr*ti + xi*tr.
    Returns (yr, yi) each (C, nj) f32."""
    C, Kc, Q_ = Tre.shape
    K1 = Kc * Q_
    L = (nj + Kc - 1) * Q_
    lhs = torch.stack([xr[:L], xi[:L]])[None]               # (1, 2, L)
    tr = Tre.reshape(C, K1)
    ti = Tim.reshape(C, K1)
    rhs = torch.cat([torch.stack([tr, -ti], 1),
                     torch.stack([ti, tr], 1)], 0)           # (2C, 2, K1)
    Y = f32_conv1d(lhs, rhs, Q_)[0]                          # (2C, nj)
    return Y[:C], Y[C:]


def strided_cfir_conv(X, Tre, Tim, Q: int, nj: int):
    """The wide matmul's contract as one strided convolution. X: (L,)
    complex64. Returns (C, nj) complex64."""
    Xr = torch.view_as_real(X.to(torch.complex64))
    yr, yi = _cfir_conv_core(Xr[:, 0], Xr[:, 1], Tre, Tim, Q, nj)
    return torch.complex(yr, yi)


def strided_cfir_conv_i16(X2, Tre, Tim, Q: int, nj: int):
    """Raw (L, 2) int16 wire samples; the taps carry the 1/32767 scale."""
    yr, yi = _cfir_conv_core(X2[:, 0].float(), X2[:, 1].float(), Tre, Tim, Q, nj)
    return torch.complex(yr, yi)


def strided_cfir_conv_u8(X2, Tre, Tim, Q: int, nj: int):
    """Raw (L, 2) uint8 RTL-SDR samples, value (b - 127.5)/127.5: the taps
    carry 1/127.5, and the -127.5 offset is a per-channel complex DC term
    from the tap sums, subtracted after the product (the wide path's
    algebra)."""
    C = Tre.shape[0]
    yr, yi = _cfir_conv_core(X2[:, 0].float(), X2[:, 1].float(), Tre, Tim, Q, nj)
    sre = 127.5 * Tre.reshape(C, -1).sum(1)
    sim = 127.5 * Tim.reshape(C, -1).sum(1)
    return torch.complex(yr - (sre - sim)[:, None], yi - (sre + sim)[:, None])
