"""WBFM broadcast receiver chain (port of ``tpudsp/chains/wbfm.py``,
BASELINE config 2): 2.4 Msps IQ -> channel filter + decimate -> FM
discriminator -> audio decimate -> de-emphasis -> 48 kHz PCM (mono), or ->
FM stereo composite decoding (stereo).

Mono is a one-channel ``ReceiverBank`` (chains/bank.py). Stereo runs the
discriminator at a 600 ksps composite rate and feeds the block-parallel
pilot-squaring stereo decoder (``kernels/pll.stereo_pilot_apply``, whose
two pilot smoothers are first_order_scan's complex64 call); its L/R
de-emphasis is one first_order_scan launch of two rows; its two strided
convolutions run in full f32 (TF32 off).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..cuda import first_order
from ..design import firdes, iirdes
from ..kernels import f32_conv1d
from ..kernels import freqdem as kfd
from ..kernels import nco as knco
from ..kernels import pll as kpll
from .am import check_format, check_input
from .bank import BankConfig, ReceiverBank
from .metrics import BlockMetrics

TWO_PI = 2.0 * np.pi


def mono_receiver(freq_offset_hz: float = 0.0, iq_rate: float = 2_400_000.0,
                  block_len: int = 1_000_000, *, device="cuda") -> ReceiverBank:
    """Mono WBFM: decimate 2.4M -> 240k, freqdem, decimate -> 48k, deemph."""
    chan_rate = iq_rate / 10
    cfg = BankConfig(freqs=(freq_offset_hz,), iq_rate=iq_rate, demod="fm",
                     decim1=10, decim2=5, kd=75_000.0 / chan_rate)
    return ReceiverBank(cfg, block_len=block_len, device=device)


class StereoState(NamedTuple):
    in_tail: torch.Tensor
    fd_prev: torch.Tensor
    pilot: kpll.StereoPilotState
    aud_tail: torch.Tensor
    dl: torch.Tensor
    dr: torch.Tensor
    a_tail_l: torch.Tensor
    a_tail_r: torch.Tensor


class StereoParams(NamedTuple):
    h1: torch.Tensor        # (2, 2, taps1) f32: the channel lowpass on (re, im)
    h2: torch.Tensor        # (2, taps2) f32: the audio decimator's two phases
    h_aud: torch.Tensor     # the stereo audio lowpass, f32
    dtheta_u: int           # the 19 kHz pilot's per-sample phase increment (32-bit)
    b0: torch.Tensor
    a: torch.Tensor


@dataclass(frozen=True)
class StereoConfig:
    iq_rate: float = 2_400_000.0
    decim1: int = 4     # 2.4M -> 600k composite rate (fits 19/38/53 kHz)
    decim2: int = 25    # audio rate = 2*comp_rate/decim2 (600k -> 48k): the
                        # fractional 12.5x decimation runs as two strided-by-
                        # decim2 convolutions offset by decim2/2 samples
    taps1: int = 96
    taps2: int = 256
    kd: float = 4.0

    @functools.cached_property
    def deemph(self) -> tuple:
        """The float64 de-emphasis pair (b0, a) at the composite rate,
        derived once from the config."""
        return iirdes.deemphasis_coeffs(self.iq_rate / self.decim1)


def _dec_audio(h2, D2: int, tail, xs):
    """The 600k -> 48k decimation of rows xs (R, n) with carried tails (R,
    taps2-1): output 2k at composite position 25k (phase-0 taps), output
    2k+1 at 25k + 12.5 (the half-sample taps, window shifted by D2 // 2).
    Returns (new tails, (R, 2 m))."""
    A = torch.cat([tail, xs], 1)[:, None]
    o0 = f32_conv1d(A, h2[0][None, None], D2)[:, 0]
    o1 = f32_conv1d(A[..., D2 // 2:], h2[1][None, None], D2)[:, 0]
    m = min(o0.shape[1], o1.shape[1])
    out = torch.stack([o0[:, :m], o1[:, :m]], 2).reshape(A.shape[0], -1)
    return A[:, 0, -(h2.shape[1] - 1):], out


def _stereo_step(params: StereoParams, state: StereoState, iq, *, cfg: StereoConfig):
    """Returns (state, (pcm (M, 2) f32 on the device, BlockMetrics)):
    pilot_level / pll_freq carry the 19 kHz stereo-lock telemetry."""
    X = torch.cat([state.in_tail, iq])
    # decimate to the composite rate with a real lowpass over (re, im); raw
    # wire blocks convert at the operand (h1 carries the wire scale), the u8
    # -127.5 offset subtracted first (a DC in I/Q is a spur at 0 Hz)
    if X.ndim == 2:
        feats = X.T.float()
        if X.dtype == torch.uint8:
            feats = feats - 127.5
    else:
        feats = torch.view_as_real(X).T
    y = f32_conv1d(feats[None], params.h1, cfg.decim1)[0]
    comp_iq = torch.complex(y[0], y[1])
    fd_prev, s = kfd.freqdem_apply(cfg.kd, state.fd_prev, comp_iq)
    pilot, lr, (pilot_level, pilot_freq) = kpll.stereo_pilot_apply(
        state.pilot, s, params.dtheta_u, with_metrics=True)
    aud_tail, (left, right) = kpll.stereo_matrix_lowpass(params.h_aud, state.aud_tail, s, lr)
    # de-emphasis at the composite rate: both channels in one blocked scan
    d_last, lr_de = first_order.first_order_apply_blocked(
        *cfg.deemph, torch.stack([state.dl, state.dr]), torch.stack([left, right]))
    tails, pcm = _dec_audio(params.h2, cfg.decim2,
                            torch.stack([state.a_tail_l, state.a_tail_r]), lr_de)
    new_state = StereoState(X[-state.in_tail.shape[0]:].clone(), fd_prev, pilot,
                            aud_tail, d_last[0], d_last[1], tails[0].clone(),
                            tails[1].clone())
    metrics = BlockMetrics(rssi=None, squelch_modes=None, pll_freq=pilot_freq,
                           resamp_credit=None, pilot_level=pilot_level)
    return new_state, (pcm.T.contiguous(), metrics)


def stereo_build(cfg: StereoConfig, input_format: str = "c64", device="cuda"):
    """(StereoParams, StereoState) on ``device`` from the JAX package's
    float64 host design; the wire scale folds into the channel lowpass."""
    check_format(input_format)
    comp_rate = cfg.iq_rate / cfg.decim1       # 600 k
    h1 = firdes.kaiser_lowpass(cfg.taps1, 0.45 / cfg.decim1, 60.0)[::-1]
    h1 = h1 * {"c64": 1.0, "i16": 1.0 / 32767.0, "u8": 1.0 / 127.5}[input_format]
    h1 = np.stack([np.stack([h1, np.zeros_like(h1)]),
                   np.stack([np.zeros_like(h1), h1])]).astype(np.float32)
    # audio decimation taps: prototype at the composite rate, cutoff 21.6
    # kHz; two polyphase rows for output positions k*25/2 (even k: offset
    # 0, odd k: 12.5, the taps sampled at half-integer offsets)
    L = cfg.taps2
    proto = firdes.kaiser_lowpass(L, 21600.0 / comp_rate, 60.0)
    proto_half = firdes.kaiser_lowpass(L, 21600.0 / comp_rate, 60.0, mu=0.5)
    h2 = np.stack([proto[::-1], proto_half[::-1]]).astype(np.float32)
    b0, aa = cfg.deemph
    h_aud = firdes.stereo_audio_lowpass(comp_rate)
    f32 = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    params = StereoParams(f32(h1), f32(h2), f32(h_aud),
                          knco.rad_to_u32(TWO_PI * 19000.0 / comp_rate), f32(b0), f32(aa))
    if input_format == "i16":
        in_tail = torch.zeros((cfg.taps1 - 1, 2), dtype=torch.int16, device=device)
    elif input_format == "u8":
        # 127 ~ zero signal to within half an LSB
        in_tail = torch.full((cfg.taps1 - 1, 2), 127, dtype=torch.uint8, device=device)
    else:
        in_tail = torch.zeros((cfg.taps1 - 1,), dtype=torch.complex64, device=device)
    zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
    state = StereoState(
        in_tail=in_tail,
        fd_prev=kfd.freqdem_init(device),
        pilot=kpll.stereo_pilot_init(device),
        aud_tail=torch.zeros((len(h_aud) - 1,), dtype=torch.complex64, device=device),
        dl=zero(), dr=zero(),
        a_tail_l=torch.zeros((cfg.taps2 - 1,), dtype=torch.float32, device=device),
        a_tail_r=torch.zeros((cfg.taps2 - 1,), dtype=torch.float32, device=device),
    )
    return params, state


class WBFMStereoReceiver:
    """Stereo WBFM at 2.4 Msps on ``device`` (the card unless the caller
    asks for the CPU): decimate to a 600 ksps composite, FM discriminator,
    pilot-squaring stereo decode, de-emphasis, and a two-phase polyphase
    decimation 600k -> 48k. Takes c64, or raw (N, 2) i16 / u8 blocks."""

    def __init__(self, cfg: StereoConfig = StereoConfig(),
                 block_len: int = 1_000_000, input_format: str = "c64", *,
                 device="cuda"):
        if block_len % (cfg.decim1 * cfg.decim2):
            raise ValueError("block_len must be a multiple of decim1*decim2")
        self.cfg = cfg
        self.input_format = input_format
        self._params, self.state = stereo_build(cfg, input_format, device)
        self.block_len = block_len
        self.metrics = None

    @property
    def device(self) -> torch.device:
        return self._params.h1.device

    def __call__(self, iq):
        """Returns (M, 2) f32 PCM on the device (no host sync); sets
        ``metrics`` (pilot_level, pll_freq) for the block."""
        iq = check_input(iq, self.input_format, self.device)
        if iq.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} samples")
        self.state, (pcm, metrics) = _stereo_step(self._params, self.state, iq,
                                                  cfg=self.cfg)
        self.metrics = metrics
        return pcm
