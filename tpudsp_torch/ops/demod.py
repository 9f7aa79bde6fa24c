"""Demodulator op classes (port of ``tpudsp/ops/demod.py``): FreqDem,
AmpModem, SSBDemod, FMStereo and BroadcastAM.

Their sequential parts run as the port's kernels on the card: the carrier
PLL as ``csrc/pll_scan.cu`` (AmpModem, BroadcastAM), the one-poles as
``csrc/first_order_scan.cu`` (AmpModem's DC tracker, FMStereo's pilot
smoothers through its complex64 entry and its L/R de-emphasis as one
2-row launch) and BroadcastAM's DC block as ``csrc/biquad_scan.cu``.
FMStereo's de-emphasis runs the blocked double-float scan on the float64
design values, where the JAX op runs the plain f32 associative scan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import biquad_scan, first_order, pll_scan
from ..design import firdes, iirdes
from ..kernels import ampmodem as kam
from ..kernels import fir as kfir
from ..kernels import freqdem as kfd
from ..kernels import hilbert as khilb
from ..kernels import iir as kiir
from ..kernels import lanes
from ..kernels import nco as knco
from ..kernels import pll as kpll
from ..kernels import resamp as krs
from .base import StatefulOp, as_c64, resolve_device, to_numpy, to_tensor


class FreqDem(StatefulOp):
    """FM demodulator: FreqDem(kd); y[n] = arg(conj(x[n-1]) x[n]) / (2 pi
    kd)."""

    def __init__(self, kd, *, device=None):
        self._device = resolve_device(device)
        self._kd = float(kd)
        self.reset()

    def reset(self):
        self._state = kfd.freqdem_init(self._device)

    def print(self):
        print(f"freqdem [kd: {self._kd:.4f}]")

    def __call__(self, inp):
        x = as_c64(inp, self._device)
        self._state, y = kfd.freqdem_apply(self._kd, self._state, x)
        return to_numpy(y)


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


class SSBDemod(StatefulOp):
    """SSB demodulator by the Hilbert sideband split: SSBDemod(band), band
    in {'usb', 'lsb'}; keeps that output of the c2r split."""

    HILB_M = 25   # the reference's firhilbf_create(25, 60)

    def __init__(self, band, *, device=None):
        self._device = resolve_device(device)
        self._usb = band == "usb"
        self._h = torch.tensor(firdes.hilbert_fir(self.HILB_M, 60.0).astype(np.float32),
                               device=self._device)
        self.reset()

    def reset(self):
        self._state = khilb.c2r_init(self.HILB_M, self._device)

    def __call__(self, inp):
        x = as_c64(inp, self._device)
        self._state, (lower, upper) = khilb.c2r_apply(self._h, self._state, x)
        return to_numpy(upper if self._usb else lower)


class FMStereo(StatefulOp):
    """Composite WBFM stereo decoder: FMStereo(iq_rate=600000.0,
    pcm_rate=48000.0). freqdem (kd = 4) -> the pilot-squaring L-R demod
    (``kernels/pll.stereo_pilot_apply``) -> audio-band lowpass and stereo
    matrix -> 75 us de-emphasis per channel at iq_rate -> resampling per
    channel to pcm_rate -> an (N, 2) float32 array of L, R pairs, as the
    JAX op emits them. Every stage is block-parallel."""

    def __init__(self, iq_rate=600000.0, pcm_rate=48000.0, *, device=None):
        self._device = resolve_device(device)
        self._iq_rate = float(iq_rate)
        self._pcm_rate = float(pcm_rate)
        self._rate = self._pcm_rate / self._iq_rate
        self._b0, self._a = iirdes.deemphasis_coeffs(self._iq_rate)
        m, fc, As, npfb = firdes.default_resamp_params(self._rate)
        self._m = m
        f32 = lambda h: torch.tensor(h.astype(np.float32), device=self._device)
        self._H = f32(firdes.resamp_bank(m, fc, As, npfb))
        self._h_aud = f32(firdes.stereo_audio_lowpass(self._iq_rate))
        self._dtheta = knco.rad_to_u32(2.0 * np.pi * 19000.0 / self._iq_rate)
        self.reset()

    def reset(self):
        zero = torch.zeros((), dtype=torch.float32, device=self._device)
        self._state = (
            kfd.freqdem_init(self._device),
            kpll.stereo_pilot_init(self._device),
            kfir.fir_init(self._h_aud.shape[0], torch.complex64, self._device),
            zero,
            zero.clone(),
        )
        self._rs_l = krs.resamp_init(2 * self._m, torch.float32, self._device)
        self._rs_r = krs.resamp_init(2 * self._m, torch.float32, self._device)
        self._tau = 0.0

    @property
    def state(self):
        """Full checkpointable state: the block pytree, the resampler tails
        and the resamplers' fractional phase."""
        return {"block": lanes.tree_map(to_numpy, self._state),
                "rs_l": to_numpy(self._rs_l), "rs_r": to_numpy(self._rs_r),
                "tau": self._tau}

    def with_state(self, state):
        self._state = lanes.tree_map(lambda v: to_tensor(v, self._device), state["block"])
        self._rs_l = to_tensor(state["rs_l"], self._device)
        self._rs_r = to_tensor(state["rs_r"], self._device)
        self._tau = float(state["tau"])
        return self

    def __call__(self, inp):
        x = as_c64(inp, self._device)
        prev, pilot, aud, dl, dr = self._state
        prev, s = kfd.freqdem_apply(4.0, prev, x)   # kd = 4, as the reference's
        pilot, lr = kpll.stereo_pilot_apply(pilot, s, self._dtheta)
        aud, (left, right) = kpll.stereo_matrix_lowpass(self._h_aud, aud, s, lr)
        # both channels' de-emphasis, one 2-row blocked scan
        d, y = first_order.first_order_apply_blocked(
            self._b0, self._a, torch.stack([dl, dr]), torch.stack([left, right]))
        self._state = (prev, pilot, aud, d[0], d[1])
        n_out, q, frac, new_tau = krs.plan(self._tau, x.shape[0], self._rate)
        self._tau = new_tau
        if n_out == 0:
            ntaps = 2 * self._m
            self._rs_l = torch.cat([self._rs_l, y[0]])[-ntaps:]
            self._rs_r = torch.cat([self._rs_r, y[1]])[-ntaps:]
            return np.zeros((0, 2), np.float32)
        q = torch.from_numpy(q).to(self._device)
        frac = torch.from_numpy(frac).to(self._device)
        self._rs_l, pl = krs.resamp_apply(self._H, self._rs_l, y[0], q, frac)
        self._rs_r, pr = krs.resamp_apply(self._H, self._rs_r, y[1], q, frac)
        return to_numpy(torch.stack([pl, pr], 1))


class BroadcastAM(StatefulOp):
    """Coherent AM for broadcast audio: BroadcastAM(slen=25, exact_pll=True).
    A Kaiser lowpass (2 slen + 1 taps, Fc = 0.01, As = 40) feeds the
    carrier PLL (bw 0.001; the exact scan, or the chunked one with
    ``exact_pll=False``); the wideband path, delayed by slen to match the
    filter's group delay, is mixed down by the recovered carrier; its real
    part is DC-blocked by a cheby2 highpass (order 3, fc = 20/48000) run as
    the double-float SOS cascade (poles at radius ~0.9983)."""

    def __init__(self, slen=25, exact_pll=True, *, device=None):
        self._device = resolve_device(device)
        self._m = int(slen)
        self._exact_pll = bool(exact_pll)
        h = firdes.kaiser_lowpass(2 * self._m + 1, 0.01, 40.0)
        self._h_lp = torch.tensor(h.astype(np.float32), device=self._device)
        sos = iirdes.iirdes_sos("cheby2", "highpass", 3, 20.0 / 48000.0, Ap=0.5, As=20.0)
        self._sos = sos
        self._sos_table = torch.from_numpy(kiir.sos_table(sos)).to(self._device)
        self.reset()

    def reset(self):
        self._state = (
            kfir.fir_init(2 * self._m + 1, torch.complex64, self._device),
            kfir.delay_init(self._m, torch.complex64, self._device),
            kpll.pll_init(self._device),
            kiir.sos_init(self._sos, torch.float32, self._device),
        )

    def __call__(self, inp):
        x = as_c64(inp, self._device)
        fir_tail, delay_buf, pll_state, dc_state = self._state
        fir_tail, x0 = kfir.fir_apply(self._h_lp, fir_tail, x)
        delay_buf, x1 = kfir.delay_apply(delay_buf, x)
        scan = (pll_scan.pll_carrier_scan if self._exact_pll
                else pll_scan.pll_carrier_scan_chunked)
        pll_state, thetas = scan(lanes.one_stream(pll_state), x0[None], 0.001)
        pll_state, thetas = lanes.first_stream(pll_state), thetas[0]
        v1 = x1 * torch.polar(torch.ones_like(thetas), -thetas)
        dc_state, y = biquad_scan.sos_apply_df(self._sos_table, dc_state, v1.real.contiguous())
        self._state = (fir_tail, delay_buf, pll_state, dc_state)
        return to_numpy(y)
