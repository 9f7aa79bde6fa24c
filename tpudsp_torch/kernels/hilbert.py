"""Hilbert / half-band transforms (port of ``tpudsp/kernels/hilbert.py``),
the intended semantics of liquid's ``firhilbf`` in three modes:

  - c2r: complex -> (lower, upper) real sidebands at the same rate (as
    AmpModem's usb/lsb paths and SSBDemod use it):
        lower = I_delayed + H{Q},  upper = I_delayed - H{Q}
    (H = the odd-tap Hilbert FIR ``design/firdes.hilbert_fir``, I delayed
    by its 2m-sample group delay);
  - interp: complex at rate r -> real at 2r (half-band 2x upsample, then
    modulate to fs/4): y[k] = Re(x_up[k] j^k);
  - decim: real at rate 2r -> complex at r: mix by (-j)^k, half-band
    lowpass, every 2nd sample, times 2.

All block-parallel FIR work (``kernels/fir``) with carried tails. The
running sample index mod 4 (``parity``) is an int64 0-d tensor where the
JAX package keeps a uint32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fir


class C2RState(NamedTuple):
    fir_tail: torch.Tensor    # (4m,) float32: Hilbert FIR tail on Q
    delay_buf: torch.Tensor   # (2m,) float32: I-branch group-delay buffer


def c2r_init(m: int, device=None) -> C2RState:
    return C2RState(
        fir_tail=fir.fir_init(4 * m + 1, torch.float32, device),
        delay_buf=fir.delay_init(2 * m, torch.float32, device),
    )


def c2r_apply(h_hilb, state: C2RState, x):
    """x: (N,) complex64 -> (new_state, (lower, upper)) float32 each (N,)."""
    tail, hq = fir.fir_apply(h_hilb, state.fir_tail, x.imag.float())
    dbuf, i_d = fir.delay_apply(state.delay_buf, x.real.float())
    return C2RState(tail, dbuf), (i_d + hq, i_d - hq)


class InterpState(NamedTuple):
    tail: torch.Tensor    # (4m,) complex64 half-band tail (on zero-stuffed x)
    parity: torch.Tensor  # int64: running output-sample index mod 4


def interp_init(m: int, device=None) -> InterpState:
    return InterpState(tail=fir.fir_init(4 * m + 1, torch.complex64, device),
                       parity=torch.zeros((), dtype=torch.int64, device=device))


def _quarter_phases(parity, n: int):
    """(parity + k) mod 4 for k = 0..n-1."""
    return (parity + torch.arange(n, device=parity.device)) & 3


def interp_apply(h_hb, state: InterpState, x):
    """x: (N,) complex64 -> (new_state, y (2N,) float32)."""
    n = x.shape[0]
    up = torch.zeros((2 * n,), dtype=torch.complex64, device=x.device)
    up[::2] = 2.0 * x   # zero-stuff; 2x gain restores amplitude
    tail, xf = fir.fir_apply(h_hb, state.tail, up)
    ph = _quarter_phases(state.parity, 2 * n)
    # Re(xf j^k): phases 0, 1, 2, 3 -> Re, -Im, -Re, Im
    re, im = xf.real, xf.imag
    y = torch.where(ph == 0, re, torch.where(ph == 1, -im, torch.where(ph == 2, -re, im)))
    return InterpState(tail, (state.parity + 2 * n) & 3), y.float()


class DecimState(NamedTuple):
    tail: torch.Tensor    # (4m,) complex64 half-band tail
    parity: torch.Tensor  # int64: running input index mod 4


def decim_init(m: int, device=None) -> DecimState:
    return DecimState(tail=fir.fir_init(4 * m + 1, torch.complex64, device),
                      parity=torch.zeros((), dtype=torch.int64, device=device))


def decim_apply(h_hb, state: DecimState, x):
    """x: (N,) float32, N even -> (new_state, y (N//2,) complex64)."""
    n = x.shape[0]
    ph = _quarter_phases(state.parity, n)
    zero = torch.zeros_like(x)
    # x (-j)^k: phases 0..3 -> (x, 0), (0, -x), (-x, 0), (0, x)
    re = torch.where(ph == 0, x, torch.where(ph == 2, -x, zero))
    im = torch.where(ph == 1, -x, torch.where(ph == 3, x, zero))
    tail, xf = fir.fir_apply(h_hb, state.tail, torch.complex(re, im))
    y = 2.0 * xf[::2]
    return DecimState(tail, (state.parity + n) & 3), y
