"""NCO / VCO op class (port of ``tpudsp/ops/nco_op.py``).

NCO(type='nco'): a numerically controlled oscillator with liquid's 32-bit
modular phase (``kernels/nco``), live freq / phase properties, a PLL step
and block mix_up / mix_down. ``type='vco'`` is accepted for parity: in
liquid the VCO differs only in how it evaluates sin / cos, which is moot
here. The phase and the per-sample increment are host integers in [0,
2^32); a block's angles are made on the op's device.
"""

from __future__ import annotations

import numpy as np

from ..kernels import nco as knco
from .base import StatefulOp, as_c64, resolve_device, to_numpy

TWO_PI = 2.0 * np.pi


class NCO(StatefulOp):
    def __init__(self, type="nco", *, device=None):
        if type not in ("nco", "vco"):
            type = "vco"   # the reference: any string but "nco" selects the VCO
        self._device = resolve_device(device)
        self.type = type
        self._phase_u = 0
        self._freq = 0.0   # radians/sample
        self._dtheta_u = 0
        self.set_pll_bandwidth(0.1)

    # -- properties ------------------------------------------------------------
    @property
    def freq(self):
        """Frequency in radians/sample (liquid nco_crcf_get_frequency)."""
        return self._freq

    @freq.setter
    def freq(self, fr):
        self._freq = float(fr)
        self._dtheta_u = knco.rad_to_u32(self._freq)

    def adjust_frequency(self, df):
        self.freq = self._freq + float(df)

    @property
    def phase(self):
        """Phase in radians in [0, 2 pi) (liquid nco_crcf_get_phase)."""
        return knco.u32_to_rad(self._phase_u)

    @phase.setter
    def phase(self, phs):
        self._phase_u = knco.rad_to_u32(float(phs))

    def adjust_phase(self, dphs):
        self._phase_u = (self._phase_u + knco.rad_to_u32(float(dphs))) & knco.MASK

    # -- PLL (liquid's nco pll: frequency gain bw, phase gain sqrt(bw)) --------
    def set_pll_bandwidth(self, bw):
        self._pll_bw = float(bw)
        self._pll_alpha = float(bw)
        self._pll_beta = float(np.sqrt(bw))

    def pll_step(self, dphase):
        self.freq = self._freq + self._pll_alpha * float(dphase)
        self.adjust_phase(self._pll_beta * float(dphase))

    @property
    def state(self):
        """Full checkpointable state: the 32-bit phase (as np.uint32, like
        the JAX op's), frequency, PLL bandwidth."""
        return {"phase_u": np.uint32(self._phase_u), "freq": self._freq,
                "pll_bw": self._pll_bw}

    def with_state(self, state):
        self._phase_u = int(state["phase_u"]) & knco.MASK
        self.freq = float(state["freq"])
        self.set_pll_bandwidth(float(state["pll_bw"]))
        return self

    def print(self):
        print(
            f"nco [type: {self.type}, phase: {self.phase:.6f} rad, "
            f"freq: {self._freq:.6f} rad/sample, pll_bw: {self._pll_bw:.4f}]"
        )

    # -- block mixing ------------------------------------------------------------
    def mix_up(self, inp):
        x = as_c64(inp, self._device)
        self._phase_u, y = knco.mix_up(self._phase_u, self._dtheta_u, x)
        return to_numpy(y)

    def mix_down(self, inp):
        x = as_c64(inp, self._device)
        self._phase_u, y = knco.mix_down(self._phase_u, self._dtheta_u, x)
        return to_numpy(y)

    __call__ = mix_up   # the reference binds __call__ to mix_up
