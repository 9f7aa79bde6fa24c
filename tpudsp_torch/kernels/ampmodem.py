"""AM demodulator constants and state (port of
``tpudsp/kernels/ampmodem.py``).

The port's AM receiver runs dsb with carrier: the carrier PLL inside the
fused front (``kernels/am_backend``), then the DC tracker (one-pole,
rho = DC_RHO) as a blocked scan. The JAX package's demod state also
carries the c2r Hilbert sideband-split state; dsb never reads it, so the
port leaves it out until the SSB slice needs it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import pll

PLL_BW = 0.001       # carrier-recovery loop bandwidth (rad/sample units)
DC_RHO = 0.9995      # DC-tracking one-pole coefficient
HILB_M = 25          # sideband-split Hilbert semi-length (as SSBDemod's 25)


class AmpDemodState(NamedTuple):
    pll: pll.PllState
    dc: torch.Tensor     # f32 scalar, tracked DC (carrier mode)


def ampdemod_init(device=None) -> AmpDemodState:
    return AmpDemodState(pll=pll.pll_init(device),
                         dc=torch.tensor(0.0, dtype=torch.float32,
                                         device=device))
