"""SSB receiver chain (port of ``tpudsp/chains/ssb.py``): channel filter +
decimate -> AGC -> Hilbert sideband split -> audio.

The front end is the AM chain's fused filter-at-the-output-rate matmul
(``kernels/decimate.fused_frontend_apply_shared``: the channel lowpass
folded into the decimating polyphase), the AGC the CUDA kernel
``csrc/agc_scan.cu`` (its chunked route, or with ``exact=True`` its exact
single-lane scan), and the sideband split FIR work (``kernels/hilbert.
c2r_apply``). There is no PLL: the carrier is suppressed.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from ..cuda import agc_scan
from ..design import firdes
from ..kernels import agc as kagc
from ..kernels import decimate as kdec
from ..kernels import hilbert as khilb
from ..kernels import lanes
from ..kernels import warmup as kwarm
from . import metrics as kmet
from .am import check_input
from .metrics import BlockMetrics


@dataclass(frozen=True)
class SSBConfig:
    band: str = "usb"               # which sideband carries the voice
    bandwidth: float = 3000.0       # audio bandwidth in Hz
    iq_rate: float = 2_000_000.0
    pcm_rate: float = 48_000.0
    agc_bandwidth: float = 0.01
    agc_scale: float = 0.01
    resamp_m: int = 13
    resamp_npfb: int = 64
    chan_taps: int = 1024           # channel lowpass length at the input rate
    hilb_m: int = 25                # sideband-split semi-length (SSBDemod's 25)

    @property
    def rate(self):
        return self.pcm_rate / self.iq_rate

    # the design values the step reads, each derived once from the config

    @functools.cached_property
    def pq(self) -> tuple:
        """(P, Q): P outputs per Q inputs."""
        f = Fraction(self.rate).limit_denominator(10000)
        return f.numerator, f.denominator

    @functools.cached_property
    def warmup(self) -> int:
        """The chunked AGC's warmup window: the AGC is the chain's only
        feedback loop."""
        return kwarm.warmup_for(agc_alpha=self.agc_bandwidth)


class SSBState(NamedTuple):
    rs_tail: torch.Tensor         # fused front-end input tail (kf,) complex64
    agc: kagc.AgcState
    c2r: khilb.C2RState


class SSBParams(NamedTuple):
    taps_fused: torch.Tensor      # (P, Kc, Q) blocked offset-folded fused taps
    h_hilb: torch.Tensor
    agc: kagc.AgcParams


def build(cfg: SSBConfig, block_len: int, device="cuda"):
    """(params, init_state, n_out) on ``device`` (the card unless the caller
    asks for the CPU), from the JAX package's float64 host design;
    block_len * rate must be integral."""
    n_out_f = block_len * cfg.rate
    n_out = int(round(n_out_f))
    if abs(n_out_f - n_out) > 1e-9:
        raise ValueError(f"block_len {block_len} * rate {cfg.rate} must be integral")
    P, Q = cfg.pq
    # channel filter: a +/- bandwidth lowpass at the input rate (the
    # Hilbert split downstream rejects the mirror)
    h_ch = firdes.kaiser_lowpass(cfg.chan_taps,
                                 max(cfg.bandwidth / cfg.iq_rate, 1e-4), 80.0)
    H = firdes.resamp_bank(cfg.resamp_m, 0.45 * cfg.rate, 60.0, cfg.resamp_npfb)
    taps_raw, kf, offs = kdec.plan_fused_frontend(H, h_ch, P, Q)
    f32 = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    params = SSBParams(
        taps_fused=f32(kdec.fold_offsets(taps_raw, offs, Q)),
        h_hilb=f32(firdes.hilbert_fir(cfg.hilb_m, 60.0)),
        agc=kagc.make_params(alpha=cfg.agc_bandwidth, scale=cfg.agc_scale,
                             device=device),
    )
    state = SSBState(
        rs_tail=torch.zeros((kf,), dtype=torch.complex64, device=device),
        agc=kagc.agc_init(device=device),
        c2r=khilb.c2r_init(cfg.hilb_m, device=device),
    )
    return params, state, n_out


def ssb_step(params: SSBParams, state: SSBState, iq, *, cfg: SSBConfig,
             n_out: int, exact: bool = False):
    """iq: (N,) complex64. Returns (state, (audio (n_out,) f32,
    BlockMetrics))."""
    P, Q = cfg.pq
    rs_tail, y48 = kdec.fused_frontend_apply_shared(
        params.taps_fused, state.rs_tail, iq, Q, n_out // P)
    agc = lanes.one_stream(state.agc)
    if exact:
        agc, (z, modes) = agc_scan.agc_exact(params.agc, agc, y48[None])
    else:
        agc, (z, modes) = agc_scan.agc_chunked(params.agc, agc, y48[None],
                                               kwarm.chunk_for(cfg.warmup), cfg.warmup)
    agc = lanes.first_stream(agc)
    c2r, (lower, upper) = khilb.c2r_apply(params.h_hilb, state.c2r, z[0])
    audio = upper if cfg.band == "usb" else lower
    metrics = BlockMetrics(rssi=kmet.rssi_db(agc.g), squelch_modes=modes[0],
                           pll_freq=None, resamp_credit=None)
    return SSBState(rs_tail, agc, c2r), (audio, metrics)


class SSBReceiver:
    """Stateful SSB receiver over fixed-size complex64 IQ blocks, on
    ``device`` (the card unless the caller asks for the CPU); ``exact=True``
    runs the AGC's exact sequential scan instead of the chunked one."""

    def __init__(self, cfg: SSBConfig = SSBConfig(), block_len: int = 1_000_000,
                 exact: bool = False, *, device="cuda"):
        self.cfg = cfg
        self.block_len = int(block_len)
        self.exact = bool(exact)
        self.metrics = None
        self.params, self.state, self.n_out = build(cfg, self.block_len, device)

    @property
    def device(self) -> torch.device:
        return self.params.taps_fused.device

    def __call__(self, iq):
        """Returns audio on the device; sets ``metrics`` (rssi, squelch
        modes) for the block."""
        iq = check_input(iq, "c64", self.device)
        if iq.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} samples")
        self.state, (audio, metrics) = ssb_step(self.params, self.state, iq,
                                                cfg=self.cfg, n_out=self.n_out,
                                                exact=self.exact)
        self.metrics = metrics
        return audio
