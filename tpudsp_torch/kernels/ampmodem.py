"""AM demodulation (port of ``tpudsp/kernels/ampmodem.py``: the
demodulator ``ampdemod_apply``, dsb / usb / lsb, carrier present or
suppressed, modulation index ``mod``):

  carrier present:
      theta[n] <- carrier-PLL scan on x (bw PLL_BW): the CUDA kernel
                  csrc/pll_scan.cu on the card (cuda/pll_scan), its plain
                  version on the CPU
      v = x e^{-j theta}, elementwise here as (xr cos + xi sin,
                  xi cos - xr sin)
      m_raw = Re(v) (dsb) | the c2r sideband split of v (usb/lsb)
      y = (m_raw - DC) / mod, DC tracked by a one-pole (rho = DC_RHO) run
                  as the blocked double-float scan: the CUDA kernel
                  csrc/first_order_scan.cu on the card (cuda/first_order),
                  kernels/iir on the CPU
  carrier suppressed:
      dsb: y = Re(x) / mod;  usb/lsb: the c2r split of x, / mod

The port's fused AM receiver runs dsb with carrier inside its fused front
kernel instead (kernels/am_backend); it keeps the same state type.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cuda import first_order, pll_scan
from . import hilbert, lanes, pll

PLL_BW = 0.001       # carrier-recovery loop bandwidth (rad/sample units)
DC_RHO = 0.9995      # DC-tracking one-pole coefficient
HILB_M = 25          # sideband-split Hilbert semi-length (as SSBDemod's 25)
AM_TYPES = ("dsb", "usb", "lsb")


class AmpDemodState(NamedTuple):
    pll: pll.PllState
    dc: torch.Tensor               # f32 scalar, tracked DC (carrier mode)
    c2r: hilbert.C2RState          # sideband-split state (usb/lsb)


def ampdemod_init(m: int = HILB_M, device=None) -> AmpDemodState:
    return AmpDemodState(pll=pll.pll_init(device),
                         dc=torch.tensor(0.0, dtype=torch.float32,
                                         device=device),
                         c2r=hilbert.c2r_init(m, device))


def ampdemod_apply(state: AmpDemodState, x, h_hilb, mod_index, am_type: str,
                   carrier: bool, exact_pll: bool = True):
    """x: (N,) complex64 -> (new_state, y (N,) float32). The carrier scan is
    exact unless ``exact_pll=False`` (pll_carrier_scan_chunked with its
    default chunk and warmup)."""
    inv_mod = float(np.float32(1.0) / np.float32(mod_index))
    pst, dc, c2r = state
    vr, vi = x.real, x.imag
    if carrier:
        scan = (pll_scan.pll_carrier_scan if exact_pll
                else pll_scan.pll_carrier_scan_chunked)
        pst, thetas = scan(lanes.one_stream(pst), x[None], PLL_BW)
        pst, thetas = lanes.first_stream(pst), thetas[0]
        c, s = torch.cos(thetas), torch.sin(thetas)
        vr, vi = vr * c + vi * s, vi * c - vr * s
    if am_type == "dsb":
        m_raw = vr
    else:
        c2r, (lower, upper) = hilbert.c2r_apply(h_hilb, c2r,
                                                torch.complex(vr, vi))
        m_raw = upper if am_type == "usb" else lower
    if carrier:
        dc, dc_track = first_order.first_order_apply_blocked(
            1.0 - DC_RHO, DC_RHO, dc, m_raw)
        y = (m_raw - dc_track) * inv_mod
    else:
        y = m_raw * inv_mod
    return AmpDemodState(pst, dc, c2r), y
