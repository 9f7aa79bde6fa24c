"""AM receiver chain (port of ``tpudsp/chains/am.py``, BASELINE config 1).

    pcm = deemph( am( agc( resample( bandpass(iq) ))))

over fixed-size IQ blocks with explicit carried state. Two plans, as in
the JAX package:

- ``fused`` (default): the bandpass IIR (as its truncated impulse
  response) is folded into the decimating polyphase resampler and
  evaluated only at the 48 kHz output points as one strided matmul
  (``kernels/decimate``). It needs a rational rate; the receiver takes
  the composed plan otherwise.
- ``composed``: each stage in the reference's order, the bandpass as an
  overlap-save FIR (``kernels/fir``, ``torch.fft``) and the resampler's
  gather and dot (``kernels/resamp``).

Two back ends (AGC -> AmpModem -> de-emphasis at the pcm rate):

- ``'kernel'`` (the port's default; ``'pallas'`` is another name for it,
  so that the JAX package's keyword values work): the AGC + squelch +
  carrier-PLL feedback core in the CUDA kernel ``csrc/am_front_scan.cu``,
  then the DC tracker and de-emphasis in one launch of
  ``csrc/first_order_scan.cu``. The JAX package runs its Pallas kernel
  only while the warmup fits a VMEM cap (``PALLAS_WARMUP_MAX``) and falls
  back to XLA scans beyond it; the CUDA kernel reads its warmup windows
  from device memory, so the port runs it at any warmup. Its chunk is
  ``warmup.chunk_for(warmup)`` (3840 at the default config), the chunk of
  the JAX package's XLA back end.
- ``'xla'`` (the JAX package's default): the chunked AGC
  (``cuda/agc_scan.agc_chunked``, csrc/agc_scan.cu), AmpModem with the
  chunked carrier PLL (csrc/pll_scan.cu, libm atan2) and its DC tracker,
  then the de-emphasis (each a csrc/first_order_scan.cu launch). With
  ``exact=True`` the AGC and the PLL run their exact single-lane scans
  instead; the fused-kernel back end is the chunked path, so it refuses
  ``exact=True`` (ValueError), as the JAX package's does. A receiver built
  with ``exact=True`` and no ``backend`` takes ``'xla'``, so the JAX
  package's ``AMReceiver(cfg, n, exact=True)`` runs as it is.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..cuda import agc_scan, first_order
from ..cuda.am_backend_scan import am_backend_chunked
from ..design import firdes, iirdes
from ..kernels import agc as kagc
from ..kernels import am_backend as kab
from ..kernels import ampmodem as kam
from ..kernels import decimate as kdec
from ..kernels import fir as kfir
from ..kernels import lanes
from ..kernels import resamp as krs
from ..kernels import warmup as kwarm
from ..utils.profiling import annotate
from . import metrics as kmet
from .metrics import BlockMetrics

INPUT_FORMATS = ("c64", "i16", "u8")
PLANS = ("fused", "composed")
BACKENDS = ("kernel", "pallas", "xla")   # 'pallas': the JAX name of 'kernel'


def check_format(input_format: str) -> None:
    """Raise ValueError on a wire format that is not one of INPUT_FORMATS."""
    if input_format not in INPUT_FORMATS:
        raise ValueError(f"unknown input_format {input_format!r} "
                         "(use 'c64', 'i16' or 'u8')")


def check_input(iq, input_format: str, device):
    """iq as a contiguous tensor on ``device``: (N,) complex64, or for
    'i16' / 'u8' a raw (N, 2) int16 / uint8 block (TypeError otherwise)."""
    iq = torch.as_tensor(iq, device=device)
    if input_format in ("i16", "u8"):
        want = torch.int16 if input_format == "i16" else torch.uint8
        if iq.dtype != want or iq.ndim != 2 or iq.shape[1] != 2:
            raise TypeError(
                f"input_format={input_format!r} expects (N, 2) {want} "
                f"[re, im]; got {iq.dtype} {tuple(iq.shape)}")
    else:
        iq = iq.to(torch.complex64)
        if iq.ndim != 1:
            raise TypeError(f"input_format='c64' expects (N,) complex; "
                            f"got shape {tuple(iq.shape)}")
    return iq.contiguous()


@dataclass(frozen=True)
class AMConfig:
    bandwidth: float = 15000.0      # bandpass cutoff in Hz
    iq_rate: float = 2_000_000.0
    pcm_rate: float = 48_000.0
    order: int = 8                  # cheby2 order
    modulation: float = 0.5
    carrier: bool = True
    agc_bandwidth: float = 0.01
    agc_scale: float = 0.01
    # squelch gating in the chain's AGC: below-threshold audio is zeroed by
    # the FSM and the per-sample modes land in BlockMetrics.squelch_modes
    squelch: bool = False
    squelch_threshold: float = 0.0  # dB (rssi = -20 log10 gain)
    squelch_timeout: int = 100      # SIGNALLO -> TIMEOUT countdown samples
    resamp_m: int = 13
    resamp_npfb: int = 64

    @property
    def rate(self) -> float:
        return self.pcm_rate / self.iq_rate

    # the design values the steps read, each derived once from the config

    @functools.cached_property
    def pq(self):
        """(P, Q): P outputs per Q inputs of a rational rate; None else."""
        f = Fraction(self.rate).limit_denominator(10000)
        return (f.numerator, f.denominator) if abs(float(f) - self.rate) < 1e-12 else None

    @functools.cached_property
    def warmup(self) -> int:
        """The chunked loops' warmup window (kernels/warmup.py): the AGC,
        the carrier PLL and the squelch countdown."""
        return kwarm.warmup_for(
            agc_alpha=self.agc_bandwidth,
            pll_bw=kam.PLL_BW if self.carrier else None,
            squelch_timeout=self.squelch_timeout if self.squelch else 0)

    @functools.cached_property
    def deemph(self) -> tuple:
        """The float64 de-emphasis pair (b0, a) at the pcm rate."""
        return iirdes.deemphasis_coeffs(self.pcm_rate)


class AMState(NamedTuple):
    fir_tail: torch.Tensor      # bandpass tail of the composed plan (zeros)
    rs_tail: torch.Tensor       # resampler input tail (c64, or raw (kf, 2))
    agc: kagc.AgcState
    am: kam.AmpDemodState
    deemph: torch.Tensor


class AMParams(NamedTuple):
    h_bp: torch.Tensor          # bandpass truncated impulse response
    H_rs: torch.Tensor          # polyphase bank (npfb+1, 2m) [composed]
    taps_fused: torch.Tensor    # (P, Kc, Q) blocked flipped fused taps [fused]
    q: torch.Tensor             # (n_out,) window starts for this block size
    frac: torch.Tensor          # (n_out,) fractional phases
    h_hilb: torch.Tensor
    agc: kagc.AgcParams
    deemph_b0: torch.Tensor
    deemph_a: torch.Tensor
    mod: torch.Tensor
    u8_dc: torch.Tensor | None = None  # (P,) per-phase tap sums (u8 wire)


def build(cfg: AMConfig, block_len: int, input_format: str = "c64",
          device="cuda"):
    """Design-time: build (params, init_state, n_out) on ``device`` (the
    card unless the caller asks for the CPU).
    block_len * rate must be integral. The design runs on the host in
    float64 exactly as the JAX package's ``build``; tensors are made once.

    input_format='i16' plans for raw interleaved int16 IQ: the 1/32767
    scale folds into the fused taps and the carried tail stays int16.
    'u8' plans for RTL-SDR bytes: the taps carry 1/127.5 and ``u8_dc`` the
    per-phase tap sums."""
    check_format(input_format)
    rate = cfg.rate
    n_out_f = block_len * rate
    n_out = int(round(n_out_f))
    if abs(n_out_f - n_out) > 1e-9:
        raise ValueError(
            f"block_len {block_len} * rate {rate} must be integral, got {n_out_f}"
        )
    pq = cfg.pq
    if pq is None and input_format != "c64":
        raise ValueError(f"input_format={input_format!r} needs the fused plan "
                         "(a rational rate)")
    sos = iirdes.iirdes_sos("cheby2", "lowpass", cfg.order,
                            cfg.bandwidth / cfg.iq_rate, As=60.0, Ap=0.5)
    h_bp = iirdes.sos_impulse_response(sos, tol=1e-11)
    if h_bp is None:
        raise ValueError("bandpass impulse response does not truncate")
    H = firdes.resamp_bank(cfg.resamp_m, 0.45 * rate, 60.0, cfg.resamp_npfb)
    _, q, frac, _ = krs.plan(0.0, block_len, rate)
    assert len(q) == n_out
    # the fused taps exist for a rational rate only (the composed plan
    # does not read them)
    taps_fused = np.zeros((1, 1, 1), np.float32)
    if pq is not None:
        taps_raw, _, offs = kdec.plan_fused_frontend(H, h_bp, *pq)
        taps_fused = kdec.fold_offsets(taps_raw, offs, pq[1])
    u8_dc = None
    if input_format == "i16":
        taps_fused = taps_fused * np.float32(1.0 / 32767.0)
    elif input_format == "u8":
        u8_dc = taps_fused.reshape(taps_fused.shape[0], -1).sum(axis=1)
        taps_fused = taps_fused * np.float32(1.0 / 127.5)

    f32 = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    de_b0, de_a = cfg.deemph
    params = AMParams(
        h_bp=f32(h_bp),
        H_rs=f32(H),
        taps_fused=f32(taps_fused),
        q=torch.tensor(q, device=device),
        frac=f32(frac),
        h_hilb=f32(firdes.hilbert_fir(kam.HILB_M, 60.0)),
        agc=kagc.make_params(alpha=cfg.agc_bandwidth, scale=cfg.agc_scale,
                             squelch=cfg.squelch,
                             threshold=cfg.squelch_threshold,
                             timeout=cfg.squelch_timeout, device=device),
        deemph_b0=f32(de_b0),
        deemph_a=f32(de_a),
        mod=f32(cfg.modulation),
        u8_dc=None if u8_dc is None else f32(u8_dc),
    )
    kf = max(2 * cfg.resamp_m, len(h_bp) + 2 * cfg.resamp_m - 1)
    if input_format == "i16":
        rs_tail = torch.zeros((kf, 2), dtype=torch.int16, device=device)
    elif input_format == "u8":
        # 127 ~ zero signal to within half an LSB (127.5 unrepresentable)
        rs_tail = torch.full((kf, 2), 127, dtype=torch.uint8, device=device)
    else:
        rs_tail = torch.zeros((kf,), dtype=torch.complex64, device=device)
    state = AMState(
        fir_tail=torch.zeros((max(len(h_bp) - 1, 0),), dtype=torch.complex64,
                             device=device),
        rs_tail=rs_tail,
        agc=kagc.agc_init(squelch=cfg.squelch, timeout=cfg.squelch_timeout,
                          device=device),
        am=kam.ampdemod_init(device=device),
        deemph=torch.tensor(0.0, dtype=torch.float32, device=device),
    )
    return params, state, n_out


def _check_back_end(exact: bool, backend: str | None) -> str:
    """The back end's name: None is 'xla' with exact=True and 'kernel'
    otherwise, 'pallas' is 'kernel'; raise on an unknown one and on the
    fused-kernel back end asked for with exact=True."""
    if backend is None:
        return "xla" if exact else "kernel"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (use 'kernel', 'pallas' or 'xla')")
    if backend != "xla" and exact:
        raise ValueError(f"backend={backend!r} requires exact=False "
                         "(the fused kernel is the chunked path)")
    return "kernel" if backend == "pallas" else backend


def _back_end(params: AMParams, state: AMState, baseband, cfg: AMConfig,
              exact: bool = False, backend: str | None = None):
    """AGC -> AmpModem -> de-emphasis at the pcm rate: through the fused
    front kernel (cuda/am_backend_scan.am_backend_chunked), or with
    backend='xla' through the separate AGC and carrier-PLL scans (chunked,
    or exact with exact=True) and two blocked first-order scans."""
    backend = _check_back_end(exact, backend)
    warmup = cfg.warmup
    de_b0, de_a = cfg.deemph
    if backend == "kernel":
        p = kab.make_params(params.agc, params.mod, de_b0, de_a,
                            carrier=cfg.carrier)
        st = kab.AmBackendState(agc=state.agc, pll=state.am.pll,
                                dc=state.am.dc, deemph=state.deemph)
        st, (pcm, modes) = am_backend_chunked(
            p, st, baseband, kwarm.chunk_for(warmup), warmup=warmup)
        am = kam.AmpDemodState(pll=st.pll, dc=st.dc, c2r=state.am.c2r)
        return st.agc, am, st.deemph, pcm, modes
    agc_st = lanes.one_stream(state.agc)
    if exact:
        agc_st, (z, modes) = agc_scan.agc_exact(params.agc, agc_st, baseband[None])
    else:
        agc_st, (z, modes) = agc_scan.agc_chunked(
            params.agc, agc_st, baseband[None], kwarm.chunk_for(warmup), warmup)
    am, audio = kam.ampdemod_apply(state.am, z[0], params.h_hilb, cfg.modulation,
                                   "dsb", cfg.carrier, exact_pll=exact)
    deemph, pcm = first_order.first_order_apply_blocked(de_b0, de_a, state.deemph, audio)
    return lanes.first_stream(agc_st), am, deemph, pcm, modes[0]


def _metrics(agc_state, am_state, modes, device) -> BlockMetrics:
    return BlockMetrics(
        rssi=kmet.rssi_db(agc_state.g),
        squelch_modes=modes,
        pll_freq=am_state.pll.freq,
        # block lengths make the output count integral, so the carried
        # fractional credit is 0 by construction
        resamp_credit=torch.zeros((), dtype=torch.float32, device=device),
    )


def am_step_composed(params: AMParams, state: AMState, iq, *, cfg: AMConfig,
                     exact: bool = False, backend: str | None = None):
    """The reference-ordered chain: bandpass (overlap-save FIR) -> resample
    -> the back end. iq is (N,) complex64. Returns (state, (pcm,
    BlockMetrics))."""
    with annotate("am_step.front"):
        fir_tail, bb = kfir.fir_apply(params.h_bp, state.fir_tail, iq)
        ntaps = params.H_rs.shape[1]
        _, y48 = krs.resamp_apply(params.H_rs, state.rs_tail[-ntaps:], bb, params.q,
                                  params.frac)
        rs_tail = torch.cat([state.rs_tail, bb])[-state.rs_tail.shape[0]:]
    with annotate("am_step.back"):
        agc_state, am_state, d_state, pcm, modes = _back_end(
            params, state, y48, cfg, exact, backend)
    new_state = AMState(fir_tail, rs_tail, agc_state, am_state, d_state)
    return new_state, (pcm, _metrics(agc_state, am_state, modes, pcm.device))


def am_step_fused(params: AMParams, state: AMState, iq, *, cfg: AMConfig,
                  exact: bool = False, backend: str | None = None):
    """Fused front end (bandpass + anti-alias + decimate at the output
    points, one strided matmul) and the fused back end. iq is (N,)
    complex64, or (N, 2) raw int16 / uint8 when built for 'i16' / 'u8'.
    Returns (state, (pcm, BlockMetrics))."""
    with annotate("am_step.front"):
        P, Q = cfg.pq
        nj = params.q.shape[0] // P
        if state.rs_tail.dtype == torch.uint8:
            rs_tail, y48 = kdec.fused_frontend_apply_shared_u8(
                params.taps_fused, params.u8_dc, state.rs_tail, iq, Q, nj)
        elif state.rs_tail.dtype == torch.int16:
            rs_tail, y48 = kdec.fused_frontend_apply_shared_i16(
                params.taps_fused, state.rs_tail, iq, Q, nj)
        else:
            rs_tail, y48 = kdec.fused_frontend_apply_shared(
                params.taps_fused, state.rs_tail, iq, Q, nj)
    with annotate("am_step.back"):
        agc_state, am_state, d_state, pcm, modes = _back_end(
            params, state, y48, cfg, exact, backend)
    new_state = AMState(state.fir_tail, rs_tail, agc_state, am_state, d_state)
    return new_state, (pcm, _metrics(agc_state, am_state, modes, pcm.device))


def _param_buffers(params: AMParams):
    """(name, tensor) of every AMParams leaf; AgcParams leaves as agc_<f>."""
    for f in AMParams._fields:
        if f == "agc":
            for g in kagc.AgcParams._fields:
                yield f"agc_{g}", getattr(params.agc, g)
        else:
            yield f, getattr(params, f)


class AMReceiver(nn.Module):
    """Stateful AM receiver over fixed-size IQ blocks.

    ``AMReceiver(cfg, block_len, input_format, device=...)`` builds the
    design on the host and keeps ``AMParams`` as registered buffers on
    ``device`` (``params`` reassembles them): the card ("cuda") unless the
    caller asks for the CPU. The carried ``state`` lives
    on the same device; move a receiver by building a new one there (or
    with ``convert.from_jax``), since ``.to()`` moves buffers only.
    Calling it on one block returns the block's pcm (f32) and leaves the
    block's BlockMetrics in ``metrics``.

    ``plan`` ('fused' or 'composed'; an irrational rate takes 'composed'),
    ``exact`` and ``backend`` ('kernel', its JAX name 'pallas', or 'xla')
    mirror the JAX receiver (the module docstring says what each runs).
    With no ``backend``, exact=True takes 'xla' (the JAX receiver's
    default) and exact=False the fused kernel 'kernel'; 'kernel' or
    'pallas' asked for with exact=True is a ValueError. i16 / u8 input
    needs the fused plan."""

    def __init__(self, cfg: AMConfig = AMConfig(), block_len: int = 1_000_000,
                 input_format: str = "c64", *, plan: str = "fused",
                 exact: bool = False, backend: str | None = None,
                 device="cuda"):
        super().__init__()
        if plan not in PLANS:
            raise ValueError(f"unknown plan {plan!r} (use 'fused' or 'composed')")
        if plan == "fused" and cfg.pq is None:
            plan = "composed"
        if input_format in ("i16", "u8") and plan != "fused":
            raise ValueError(f"input_format={input_format!r} requires the "
                             "fused plan")
        self.cfg = cfg
        self.block_len = int(block_len)
        self.input_format = input_format
        self.plan = plan
        self.exact = bool(exact)
        self.backend = _check_back_end(self.exact, backend)
        params, self.state, self.n_out = build(cfg, self.block_len,
                                               input_format, device=device)
        for name, t in _param_buffers(params):
            self.register_buffer(name, t)
        self.metrics = None  # BlockMetrics of the last processed block

    @property
    def params(self) -> AMParams:
        agc = kagc.AgcParams(*(getattr(self, f"agc_{g}")
                               for g in kagc.AgcParams._fields))
        return AMParams(*(agc if f == "agc" else getattr(self, f)
                          for f in AMParams._fields))

    @property
    def device(self) -> torch.device:
        return self.taps_fused.device

    def forward(self, iq):
        with annotate("AMReceiver.step"):
            iq = check_input(iq, self.input_format, self.device)
            if iq.shape[0] != self.block_len:
                raise ValueError(f"expected block of {self.block_len} samples")
            step = am_step_fused if self.plan == "fused" else am_step_composed
            self.state, (pcm, metrics) = step(self.params, self.state, iq,
                                              cfg=self.cfg, exact=self.exact,
                                              backend=self.backend)
            self.metrics = metrics
            return pcm
