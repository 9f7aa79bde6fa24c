"""AGC op class (port of ``tpudsp/ops/agc_op.py``; reference agc.hpp,
wrapper.cpp:228-242).

AGC(): automatic gain control + squelch on complex IQ: output = scale *
gain * iq, zeroed in squelch states ENABLED(1) / SIGNALLO(5); ``onRise``
fires on transitions into RISE(2), host-side after the block, from the
per-sample squelch modes. The squelch-edge state is per instance.

Every route runs the CUDA kernel ``csrc/agc_scan.cu`` on the card
(``cuda/agc_scan``), with the JAX op's chunk and warmup, because the
chunked AGC's result depends on both:

- ``throughput_mode=True, use_pallas=True`` and warmup <= PALLAS_WARMUP_MAX:
  the Pallas route, chunk 1024;
- ``throughput_mode=True`` otherwise: the XLA route, chunk_for(warmup);
- ``throughput_mode=False`` (the default): the exact scan, one lane.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import agc_scan
from ..kernels import agc as kagc
from ..kernels import lanes
from ..kernels.warmup import PALLAS_WARMUP_MAX, chunk_for, warmup_for
from .base import StatefulOp, as_c64, resolve_device, to_numpy

PALLAS_CHUNK = 1024   # the chunk the JAX op passes its Pallas wrapper


class AGC(StatefulOp):
    def __init__(self, throughput_mode: bool = False, use_pallas: bool = False,
                 *, device=None):
        self._device = resolve_device(device)
        self._throughput = bool(throughput_mode)
        self._use_pallas = bool(use_pallas)
        self._bandwidth = 0.01       # liquid agc default loop bandwidth
        self._squelch = False
        self._threshold = 0.0
        self._timeout = 100
        self._lock = False
        self._scale = 1.0
        self._onRise = None
        self._edge_state = kagc.SQ_UNKNOWN  # per instance
        self._state = kagc.agc_init(device=self._device)

    def _set(self, **leaves):
        """Replace state leaves with host scalars of their own dtypes."""
        self._state = self._state._replace(**{
            k: torch.tensor(v, dtype=getattr(self._state, k).dtype,
                            device=self._device) for k, v in leaves.items()})

    # -- properties (wrapper.cpp:230-239) -------------------------------------
    @property
    def squelch(self):
        """Enable/disable squelch."""
        return self._squelch

    @squelch.setter
    def squelch(self, val):
        self._squelch = bool(val)
        self._set(sq_mode=kagc.SQ_ENABLED if self._squelch else kagc.SQ_DISABLED)

    @property
    def threshold(self):
        """Squelch trigger level in dB."""
        return self._threshold

    @threshold.setter
    def threshold(self, t):
        self._threshold = float(t)

    @property
    def bandwidth(self):
        """Gain-loop bandwidth / settling rate."""
        return self._bandwidth

    @bandwidth.setter
    def bandwidth(self, bw):
        self._bandwidth = float(bw)

    @property
    def level(self):
        """Current input linear level estimate = 1/gain."""
        return 1.0 / float(self._state.g)

    @level.setter
    def level(self, lvl):
        self._set(g=np.float32(1.0 / max(float(lvl), 1e-30)))

    @property
    def level_dB(self):
        """Current input level in dB = -20 log10(gain) (liquid rssi)."""
        return -20.0 * float(np.log10(max(float(self._state.g), 1e-30)))

    @level_dB.setter
    def level_dB(self, rssi):
        self._set(g=np.float32(10.0 ** (-float(rssi) / 20.0)))

    @property
    def lock(self):
        """When True, gain updates are frozen; level estimation continues."""
        return self._lock

    @lock.setter
    def lock(self, val):
        self._lock = bool(val)

    @property
    def gain(self):
        """Current linear gain."""
        return float(self._state.g)

    @gain.setter
    def gain(self, g):
        self._set(g=np.float32(g))

    @property
    def scale(self):
        """Linear output scale."""
        return self._scale

    @scale.setter
    def scale(self, s):
        self._scale = float(s)

    @property
    def status(self):
        """Squelch FSM state, in the reference's numbering."""
        return int(self._state.sq_mode)

    @property
    def onRise(self):
        """No-arg callable fired on squelch transition to RISE."""
        return self._onRise

    @onRise.setter
    def onRise(self, clb):
        self._onRise = clb

    def print(self):
        print(
            f"agc [bw: {self._bandwidth:.4f}, gain: {self.gain:.3e}, "
            f"rssi: {self.level_dB:.2f} dB, squelch: {self._squelch}, "
            f"threshold: {self._threshold:.1f} dB, lock: {self._lock}, "
            f"scale: {self._scale:.3e}, status: {self.status}]"
        )

    def reset(self):
        """Reset to defaults; cancels lock and squelch in the process."""
        self._lock = False
        self._squelch = False
        self._state = kagc.agc_init(squelch=False, timeout=self._timeout,
                                    device=self._device)
        self._edge_state = kagc.SQ_UNKNOWN

    def _route(self):
        """(scan function, its chunk/warmup kwargs) of the JAX op's route."""
        if not self._throughput:
            return agc_scan.agc_exact, {}
        warmup = warmup_for(agc_alpha=self._bandwidth,
                            squelch_timeout=self._timeout if self._squelch else 0)
        if self._use_pallas and warmup <= PALLAS_WARMUP_MAX:
            return agc_scan.agc_chunked_pallas, dict(chunk=PALLAS_CHUNK,
                                                     warmup=warmup)
        return agc_scan.agc_chunked, dict(chunk=chunk_for(warmup),
                                          warmup=warmup)

    def __call__(self, inp):
        x = as_c64(inp, self._device)
        if x.shape[0] == 0:
            return np.zeros((0,), np.complex64)
        params = kagc.make_params(
            alpha=self._bandwidth, locked=self._lock, squelch=self._squelch,
            threshold=self._threshold, timeout=self._timeout,
            scale=self._scale, device=self._device)
        scan, kw = self._route()
        st, (y, modes) = scan(params, lanes.one_stream(self._state), x[None], **kw)
        self._state = lanes.first_stream(st)
        if self._squelch:
            modes_h = to_numpy(modes[0])
            if self._onRise is not None:
                prev = np.concatenate([[self._edge_state], modes_h[:-1]])
                rises = (modes_h == kagc.SQ_RISE) & (prev != kagc.SQ_RISE)
                for _ in range(int(rises.sum())):
                    self._onRise()
            self._edge_state = int(modes_h[-1])
        return to_numpy(y[0])
