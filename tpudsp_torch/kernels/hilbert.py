"""Complex-to-real sideband split (port of the c2r mode of
``tpudsp/kernels/hilbert.py``), as AmpModem's usb/lsb paths use it:

    lower = I_delayed + H{Q},  upper = I_delayed - H{Q}

H = the odd-tap Hilbert FIR (``design/firdes.hilbert_fir``), I delayed by
its 2m-sample group delay. Block-parallel FIR work with carried tails
(``kernels/fir``). The interp and decim modes wait for HilbertTransform.
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
