"""Demodulator op classes (port of ``tpudsp/ops/demod.py``).

Ported: AmpModem. FreqDem, SSBDemod, FMStereo and BroadcastAM are not
ported yet; building one raises NotImplementedError naming its ROADMAP.md
item.
"""

from __future__ import annotations

import numpy as np
import torch

from ..design import firdes
from ..kernels import ampmodem as kam
from .base import StatefulOp, as_c64, not_ported, resolve_device, to_numpy


class AmpModem(StatefulOp):
    """AM demodulator: AmpModem(modulation=0.75, type='dsb', carrier=False).

    Semantics in ``kernels/ampmodem.py``: PLL-coherent for carrier=True
    (the exact carrier scan, the CUDA kernel csrc/pll_scan.cu on the
    card), Hilbert sideband split for usb/lsb. Setting ``modulation``,
    ``type`` or ``carrier`` rebuilds the demodulator and resets its state,
    as the reference does."""

    def __init__(self, modulation=0.75, type="dsb", carrier=False, *,
                 device=None):
        self._device = resolve_device(device)
        self._mod = float(modulation)
        self._type = type if type in kam.AM_TYPES else "dsb"
        self._carrier = bool(carrier)
        self._h_hilb = torch.tensor(
            firdes.hilbert_fir(kam.HILB_M, 60.0).astype(np.float32),
            device=self._device)
        self.reset()

    def reset(self):
        self._state = kam.ampdemod_init(device=self._device)

    # -- rebuild-on-set properties (wrapper.cpp:194-196) ----------------------
    @property
    def modulation(self):
        return self._mod

    @modulation.setter
    def modulation(self, mod):
        self._mod = float(mod)
        self.reset()

    @property
    def type(self):
        return self._type

    @type.setter
    def type(self, t):
        # the reference accepts only dsb/usb/lsb and ignores anything else
        if t in kam.AM_TYPES:
            self._type = t
            self.reset()

    @property
    def carrier(self):
        return self._carrier

    @carrier.setter
    def carrier(self, val):
        self._carrier = bool(val)
        self.reset()

    def print(self):
        print(
            f"ampmodem [modulation: {self._mod:.3f}, type: {self._type}, "
            f"carrier: {'present' if self._carrier else 'suppressed'}]"
        )

    def __call__(self, inp):
        x = as_c64(inp, self._device)
        if x.shape[0] == 0:
            return np.zeros((0,), np.float32)
        self._state, y = kam.ampdemod_apply(self._state, x, self._h_hilb,
                                            self._mod, self._type,
                                            self._carrier)
        return to_numpy(y)


FreqDem = not_ported("FreqDem", "Queue A #7")
SSBDemod = not_ported("SSBDemod", "Queue A #7")
FMStereo = not_ported("FMStereo", "Queue A #7")
BroadcastAM = not_ported("BroadcastAM", "Queue A #7")
