"""Multi-channel receiver bank (port of ``tpudsp/chains/bank.py``, BASELINE
configs 3-5).

A shared wideband IQ stream feeds C independent receiver chains
(per-channel mix -> decimating channel filter -> demod -> audio). The
per-channel mix-down folds into the channel filter:

    conv(x e^{-j w_c n}, h)[m] = e^{-j w_c m D} conv(x, h e^{+j w_c k})[m]

so one strided complex FIR with per-channel modulated taps (C outputs)
over the shared stream is the whole front end, and a closed-form phasor
(a uint32 phase lattice) applies the output rotation. On the card the
front end is one launch of the CUDA kernel ``csrc/halo_async.cu`` with the
block-carried input tail as its halo (``cuda/halo_async.cfir``; CPU tensors
take its plain version ``cfir_ref``).

The back end runs at the channel rate over the C rows at once:
discriminator (FM), envelope or the coherent AM back end (AM), the
one-sided audio decimator (USB / LSB), selected per channel by masks with
no branch; then the audio decimation (one f32 product) and the
de-emphasis (one ``csrc/first_order_scan.cu`` launch of C rows). A bank
whose every channel is FM takes the rotation and the discriminator in one
launch of ``csrc/bank_rotate.cu`` (``cuda/bank_rotate.fm_base``) from the
filter's output to the FM rows; the other banks rotate with eager passes. The
coherent AM channels' AGC + carrier PLL is one ``csrc/am_front_scan.cu``
launch over the Ca streams, their DC tracker one first_order_scan launch
of Ca rows.

``bank_step`` only enqueues device work: it reads no value of a device
tensor on the host. Its two stages are the spans ``bank_step.channelize``
(the front end, and the rotation but in an all-FM bank) and
``bank_step.demod`` (the back end, with an all-FM bank's rotation, the
audio decimation and the de-emphasis), the channelized bank's names.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..cuda import bank_rotate, first_order, halo_async
from ..cuda.am_backend_scan import front_chunked
from ..design import firdes, iirdes
from ..kernels import agc as kagc
from ..kernels import am_backend as kab
from ..kernels import ampmodem as kam
from ..kernels import decimate as kdec
from ..kernels import f32_matmul
from ..kernels import warmup as kwarm
from ..kernels.fastmath import patan2
from ..kernels.nco import _U32_TO_RAD, MASK, mul_u32
from ..kernels.pll import PllState
from ..utils.profiling import annotate
from . import metrics as kmet
from .am import _check_back_end, check_format, check_input
from .metrics import BlockMetrics

TWO_PI = 2.0 * np.pi
# the coherent AM channels' chunk on the 'kernel' back end: the JAX
# package's Pallas chunk (front_chunked_pallas' default); 'xla' takes
# warmup.chunk_for(warmup), the JAX package's XLA chunk
KERNEL_CHUNK = 1024


@functools.lru_cache(maxsize=16)
def _index_tensor(idx: tuple, device: torch.device):
    """The channel indices ``idx`` as an int64 tensor on ``device``, made
    once (a step copies nothing from the host)."""
    return torch.tensor(idx, dtype=torch.int64, device=device)


@dataclass(frozen=True)
class BankConfig:
    freqs: tuple          # per-channel center freqs in Hz
    iq_rate: float = 2_400_000.0
    # 'fm' (freqdem + deemph), 'am' (envelope, or the coherent back end with
    # am_coherent), 'usb' / 'lsb' (the complex baseband decimated through a
    # shared one-sided audio filter, Re taken; lsb conjugates the baseband),
    # or a per-channel tuple of those, run branch-free with masks
    demod: str | tuple = "fm"
    decim1: int = 10      # input rate -> channel rate
    decim2: int = 5       # channel rate -> audio rate
    # FM demod factor at the CHANNEL rate: kd = dev / chan_rate recovers the
    # message of peak deviation dev at unit gain
    kd: float = 0.3125
    taps1: int = 128      # channel filter length
    taps2: int = 64       # audio filter length
    taps2_ssb: int = 512  # SSB sideband-split filter length (channel rate)
    # coherent back end for the AM channels (AGC -> carrier PLL -> DC
    # tracker) instead of the bare envelope |y1|
    am_coherent: bool = False
    agc_bandwidth: float = 0.01   # AGC loop bw at the channel rate
    agc_scale: float = 1.0        # post-AGC output scale
    modulation: float = 1.0       # AM modulation index (audio = vr/mod)
    # squelch gating in the coherent AM channels' AGC; the per-sample FSM
    # tensor lands in BlockMetrics.squelch_modes
    squelch: bool = False
    squelch_threshold: float = 0.0  # dB at the channel rate
    squelch_timeout: int = 100

    @property
    def nchan(self):
        return len(self.freqs)

    @property
    def chan_rate(self):
        return self.iq_rate / self.decim1

    @property
    def audio_rate(self):
        return self.chan_rate / self.decim2

    @functools.cached_property
    def plan(self) -> DemodPlan:
        """The bank's back end (``demod_plan``), derived on first use."""
        return demod_plan(self)


class DemodPlan(NamedTuple):
    """A bank's back end, decided once from its config by ``demod_plan``:
    the builds derive it, the steps read it."""
    demods: tuple   # per-channel demod types
    route: str      # 'fm', 'am' (envelope), 'cam' (coherent AM), 'ssb' or 'mixed'
    am_idx: tuple   # the AM channels
    coherent: bool  # the coherent back end runs on the am_idx rows
    any_ssb: bool   # some channel is usb / lsb (every one on route 'ssb')
    deemph: tuple   # float64 (b0, a) of the de-emphasis at the rate it runs
    warmup: int     # the coherent loops' warmup window
    chunk: dict     # the coherent loops' chunk by back end ('kernel', 'xla')


def demod_plan(cfg) -> DemodPlan:
    """The plan of a BankConfig or a chains/channelizer.ChannelizedBankConfig
    (each holds its own as ``cfg.plan``). The families differ as their
    tpudsp twins do: the receiver bank de-emphasises at the audio rate and
    adds the squelch countdown to the warmup; the channelized bank
    de-emphasises at the channel rate with its own tau, and takes the
    Pallas chunk only while the warmup fits that kernel's cap."""
    if isinstance(cfg, BankConfig):
        nchan = cfg.nchan
        deemph = iirdes.deemphasis_coeffs(cfg.audio_rate)
        warmup = kwarm.warmup_for(
            agc_alpha=cfg.agc_bandwidth, pll_bw=kam.PLL_BW,
            squelch_timeout=cfg.squelch_timeout if cfg.squelch else 0)
        kernel_chunk = KERNEL_CHUNK
    else:
        nchan = cfg.channelizer.nchan
        deemph = iirdes.deemphasis_coeffs(cfg.channelizer.chan_rate, cfg.deemph_tau)
        warmup = kwarm.warmup_for(agc_alpha=cfg.agc_bandwidth, pll_bw=kam.PLL_BW)
        kernel_chunk = (KERNEL_CHUNK if warmup <= kwarm.PALLAS_WARMUP_MAX
                        else kwarm.chunk_for(warmup))
    demods = (cfg.demod,) * nchan if isinstance(cfg.demod, str) else tuple(cfg.demod)
    kinds = set(demods)
    am_idx = tuple(i for i, d in enumerate(demods) if d == "am")
    coherent = bool(cfg.am_coherent and am_idx)
    if kinds == {"fm"}:
        route = "fm"
    elif kinds == {"am"}:
        route = "cam" if coherent else "am"
    elif kinds <= {"usb", "lsb"}:
        route = "ssb"
    else:
        route = "mixed"
    return DemodPlan(demods=demods, route=route, am_idx=am_idx, coherent=coherent,
                     any_ssb=bool(kinds & {"usb", "lsb"}), deemph=deemph, warmup=warmup,
                     chunk={"kernel": kernel_chunk, "xla": kwarm.chunk_for(warmup)})


class BankParams(NamedTuple):
    taps_re: torch.Tensor    # (C, Kc, D1) f32: blocked modulated channel taps (re)
    taps_im: torch.Tensor    # (C, Kc, D1) f32: (im); correlation order
    dtheta: torch.Tensor     # (C,) int64 in [0, 2^32): per-sample phase increments
    h2: torch.Tensor         # (Kc2, D2) f32 blocked audio decimation taps (shared)
    deemph_b0: torch.Tensor
    deemph_a: torch.Tensor
    fm_mask: torch.Tensor    # (C,) bool: per-channel FM discriminator
    amb: object = None       # AmBackendParams when cfg.am_coherent
    ssb_mask: object = None  # (C,) bool: SSB channels
    h2s_re: object = None    # (Kc2s, D2) one-sided audio taps (re), shared
    h2s_im: object = None    # (Kc2s, D2) (im)
    lsb_sign: object = None  # (C,) f32: -1 for lsb channels, +1 else


class BankState(NamedTuple):
    in_tail: torch.Tensor    # (K1-1,) complex64 shared input tail, or raw (K1-1, 2)
    phase: torch.Tensor      # (C,) int64 in [0, 2^32): NCO phases at block start
    n0: torch.Tensor         # int64 in [0, 2^32): global index of the block start
    fd_prev: torch.Tensor    # (C,) complex64 discriminator carry
    a_tail: torch.Tensor     # (C, K2-1) f32 audio filter tails
    deemph: torch.Tensor     # (C,) f32 de-emphasis carry
    front: object = None     # FrontState (Ca,) of the coherent AM channels
    dc: object = None        # (Ca,) f32 DC-tracker carry (coherent AM)
    y1_tail: object = None   # (C, K2s-1) complex64 baseband tails (SSB banks)


def build(cfg: BankConfig, input_format: str = "c64", device="cuda"):
    """Design-time: (params, init_state) on ``device`` (the card unless the
    caller asks for the CPU), from the JAX package's float64 host design.
    'i16' folds the 1/32767 scale into the modulated taps and keeps the
    shared input tail raw int16; 'u8' (RTL-SDR, (b - 127.5)/127.5) folds
    1/127.5 and keeps a raw uint8 tail started at 127."""
    check_format(input_format)
    C = cfg.nchan
    plan = cfg.plan
    if len(plan.demods) != C:
        raise ValueError("per-channel demod tuple must match freqs")
    bad = [d for d in plan.demods if d not in ("fm", "am", "usb", "lsb")]
    if bad:
        raise ValueError(
            f"unknown demod type(s) {bad!r} (use 'fm'/'am'/'usb'/'lsb')")
    k = np.arange(cfg.taps1)
    h1 = firdes.kaiser_lowpass(cfg.taps1, 0.45 / cfg.decim1, 60.0)
    w = np.array([TWO_PI * f / cfg.iq_rate for f in cfg.freqs])  # rad/sample
    # modulated taps h1[k] e^{+j w_c k}, flipped to correlation order and
    # blocked by D1
    hm = (h1[None, :] * np.exp(1j * w[:, None] * k[None, :]))[:, ::-1]
    if input_format == "i16":
        hm = hm * (1.0 / 32767.0)
    elif input_format == "u8":
        hm = hm * (1.0 / 127.5)
    taps_re = kdec.plan_phase_taps(hm.real.astype(np.float32), cfg.decim1)
    taps_im = kdec.plan_phase_taps(hm.imag.astype(np.float32), cfg.decim1)
    h2p = firdes.kaiser_lowpass(cfg.taps2, 0.45 / cfg.decim2, 60.0)[::-1]
    h2 = kdec.plan_phase_taps(h2p[None, :].astype(np.float32), cfg.decim2)[0]
    b0, a = plan.deemph
    fm_mask = np.array([d == "fm" for d in plan.demods])
    ssb_mask = np.array([d in ("usb", "lsb") for d in plan.demods])
    lsb_mask = np.array([d == "lsb" for d in plan.demods])
    t = lambda v, dt=torch.float32: torch.tensor(np.asarray(v), dtype=dt, device=device)
    # SSB audio decimator: a half-width lowpass shifted to [0, 0.45/D2]
    # cycles (one-sided, lower edge at the carrier), times 2 for unit
    # message gain; lsb channels conjugate the baseband (lsb_sign)
    h2s_re = h2s_im = lsb_sign = None
    if plan.any_ssb:
        fsh2 = 0.225 / cfg.decim2
        k2 = np.arange(cfg.taps2_ssb)
        hs = 2.0 * (firdes.kaiser_lowpass(cfg.taps2_ssb, fsh2, 60.0)
                    * np.exp(2j * np.pi * fsh2 * k2))[::-1]
        h2s_re = t(kdec.plan_phase_taps(hs.real[None, :].astype(np.float32),
                                        cfg.decim2)[0])
        h2s_im = t(kdec.plan_phase_taps(hs.imag[None, :].astype(np.float32),
                                        cfg.decim2)[0])
        lsb_sign = t(np.where(lsb_mask, -1.0, 1.0))
    dtheta = [int(round((wc % TWO_PI) / TWO_PI * 2**32)) & MASK for wc in w]
    amb = front = dc0 = None
    if plan.coherent:
        Ca = len(plan.am_idx)
        amb = kab.make_params(
            kagc.make_params(alpha=cfg.agc_bandwidth, scale=cfg.agc_scale,
                             squelch=cfg.squelch,
                             threshold=cfg.squelch_threshold,
                             timeout=cfg.squelch_timeout, device=device),
            cfg.modulation, b0, a, carrier=True)
        agc0 = kagc.agc_init(squelch=cfg.squelch, timeout=cfg.squelch_timeout,
                             device=device)
        zeros = lambda: torch.zeros((Ca,), dtype=torch.float32, device=device)
        front = kab.FrontState(
            agc=kagc.AgcState(*(v.expand(Ca).contiguous() for v in agc0)),
            pll=PllState(zeros(), zeros()))
        dc0 = zeros()
    params = BankParams(
        taps_re=t(taps_re), taps_im=t(taps_im),
        dtheta=t(dtheta, torch.int64), h2=t(h2),
        deemph_b0=t(np.float32(b0)), deemph_a=t(np.float32(a)),
        fm_mask=t(fm_mask, torch.bool), amb=amb,
        ssb_mask=t(ssb_mask, torch.bool),
        h2s_re=h2s_re, h2s_im=h2s_im, lsb_sign=lsb_sign,
    )
    if input_format == "i16":
        in_tail = torch.zeros((cfg.taps1 - 1, 2), dtype=torch.int16, device=device)
    elif input_format == "u8":
        # 127 ~ zero signal to within half an LSB
        in_tail = torch.full((cfg.taps1 - 1, 2), 127, dtype=torch.uint8, device=device)
    else:
        in_tail = torch.zeros((cfg.taps1 - 1,), dtype=torch.complex64, device=device)
    state = BankState(
        in_tail=in_tail,
        phase=torch.zeros((C,), dtype=torch.int64, device=device),
        n0=torch.zeros((), dtype=torch.int64, device=device),
        fd_prev=torch.full((C,), 1.0 + 0.0j, dtype=torch.complex64, device=device),
        a_tail=torch.zeros((C, cfg.taps2 - 1), dtype=torch.float32, device=device),
        deemph=torch.zeros((C,), dtype=torch.float32, device=device),
        front=front, dc=dc0,
        y1_tail=None if not plan.any_ssb
        else torch.zeros((C, cfg.taps2_ssb - 1), dtype=torch.complex64, device=device),
    )
    return params, state


def phase_lattice(phase, n0, dtheta, D1: int, nj: int):
    """The output rotation's angles theta[c, m] = 2 pi / 2^32 x ((phase_c +
    n0 dtheta_c + m dtheta_c D1) mod 2^32), f32 (C, nj), from the integer
    rounded to nearest f32 as the JAX package converts its uint32."""
    m = torch.arange(nj, dtype=torch.int64, device=dtheta.device)
    th_u = (phase[:, None] + mul_u32(n0, dtheta)[:, None]
            + mul_u32(m[None, :], mul_u32(dtheta, D1)[:, None])) & MASK
    return th_u.to(torch.float32) * _U32_TO_RAD


def _fm_base(y1, fd_prev, kd: float):
    xprev = torch.cat([fd_prev[:, None], y1[:, :-1]], 1)
    d = y1 * torch.conj(xprev)
    return patan2(d.imag, d.real) / float(np.float32(TWO_PI * kd))


def _audio_decimate(A, h2, D2: int, nj: int):
    """Per-channel strided FIR with shared blocked taps h2 (Kc2, D2): A (C,
    L) f32 -> (C, nj). The frames' product with the taps in one f32 matmul,
    then the diagonal sum over Kc2."""
    C = A.shape[0]
    Kc2 = h2.shape[0]
    M = nj + Kc2 - 1
    Z = f32_matmul(A[:, : M * D2].reshape(C, M, D2), h2.T).contiguous()  # (C, M, Kc2)
    # acc[c, j] = sum_k Z[c, j + k, k]
    return Z.as_strided((C, nj, Kc2), (M * Kc2, Kc2, Kc2 + 1)).sum(-1)


def bank_step(params: BankParams, state: BankState, iq, *, cfg: BankConfig,
              backend: str = "kernel"):
    """iq: (N,) complex64 shared stream, or a raw (N, 2) int16 / uint8
    block for a bank built for that wire format; N a multiple of
    decim1*decim2. Returns (state, (audio (C, N/(decim1*decim2)) f32,
    BlockMetrics)).

    ``backend`` sets the coherent AM channels' chunk and warmup: both run
    the CUDA kernel csrc/am_front_scan.cu over all Ca streams in one
    launch, 'kernel' (or 'pallas') with the JAX package's Pallas chunk
    (KERNEL_CHUNK), 'xla' with its XLA chunk (warmup.chunk_for)."""
    backend = _check_back_end(False, backend)
    plan = cfg.plan
    D1, D2 = cfg.decim1, cfg.decim2
    K1, K2 = cfg.taps1, cfg.taps2
    n = iq.shape[0]

    # every channel FM: the output rotation and the discriminator are one
    # launch (cuda/bank_rotate) in the demod stage, and y1 is never formed
    with annotate("bank_step.channelize"):
        # batched mix + channelize -> (C, N/D1) complex, then (but in an
        # all-FM bank) the output rotation e^{-j w_c (n0 + m D1)} from the
        # uint32 phase lattice
        nj1 = n // D1
        y1m = halo_async.cfir(iq, state.in_tail, params.taps_re, params.taps_im, D1, nj1)
        if plan.route != "fm":
            theta = phase_lattice(state.phase, state.n0, params.dtheta, D1, nj1)
            y1 = y1m * torch.polar(torch.ones_like(theta), -theta)

    with annotate("bank_step.demod"):
        if plan.route == "fm":
            base, fd_prev = bank_rotate.fm_base(y1m, state.phase, state.n0, params.dtheta, D1,
                                                state.fd_prev, cfg.kd)
        else:
            if plan.route == "am":
                base = torch.abs(y1)
            elif plan.route == "ssb":
                # the real demod runs below through the one-sided decimator;
                # this base only keeps the (unused) a_tail carry
                base = y1.real
            elif plan.route == "mixed":   # every demod computed, selected per channel
                base = torch.where(params.fm_mask[:, None],
                                   _fm_base(y1, state.fd_prev, cfg.kd),
                                   torch.where(params.ssb_mask[:, None], y1.real,
                                               torch.abs(y1)))
            fd_prev = y1[:, -1].clone()

        front, dc = state.front, state.dc
        sq_modes = None
        if plan.coherent:
            # coherent AM channels: AGC + carrier PLL over the Ca streams in one
            # launch, the DC tracker over their rows in another, at the channel
            # rate (in a mixed bank, in place of the envelope rows of base)
            y_am = y1
            if plan.route == "mixed":
                idx = _index_tensor(plan.am_idx, y1.device)
                y_am = y1.index_select(0, idx)
            front, (vr, sq_modes) = front_chunked(params.amb, state.front, y_am,
                                                  plan.chunk[backend], plan.warmup)
            dc, dct = first_order.first_order_apply_blocked(
                1.0 - kam.DC_RHO, kam.DC_RHO, state.dc, vr)
            coh = (vr - dct) * params.amb.inv_mod
            base = base.index_copy(0, idx, coh) if plan.route == "mixed" else coh

        # audio decimation: per-channel blocked product with shared taps
        nj2 = nj1 // D2
        A = torch.cat([state.a_tail, base], 1)   # (C, K2-1+N/D1)
        audio = _audio_decimate(A, params.h2, D2, nj2)

        # SSB channels: the complex baseband through the one-sided taps, Re
        # taken; lsb channels conjugate it (lsb_sign flips Im)
        y1_tail = state.y1_tail
        if plan.any_ssb:
            K2s = cfg.taps2_ssb
            Yf = torch.cat([state.y1_tail, y1], 1)   # (C, K2s-1+N/D1)
            yi = Yf.imag * params.lsb_sign[:, None]
            audio_ssb = (_audio_decimate(Yf.real, params.h2s_re, D2, nj2)
                         - _audio_decimate(yi, params.h2s_im, D2, nj2))
            audio = audio_ssb if plan.route == "ssb" else torch.where(
                params.ssb_mask[:, None], audio_ssb, audio)
            y1_tail = Yf[:, -(K2s - 1):]

        # de-emphasis over the C rows: one blocked scan (float64 design values)
        deemph, audio = first_order.first_order_apply_blocked(*plan.deemph, state.deemph, audio)

    new_state = BankState(
        in_tail=torch.cat([state.in_tail, iq[-(K1 - 1):]])[-(K1 - 1):],
        phase=state.phase,
        n0=(state.n0 + n) & MASK,
        fd_prev=fd_prev,
        a_tail=A[:, -(K2 - 1):].clone(),
        deemph=deemph,
        front=front, dc=dc,
        y1_tail=None if y1_tail is None else y1_tail.clone(),
    )
    metrics = BlockMetrics(
        rssi=None if front is None else kmet.rssi_db(front.agc.g),
        squelch_modes=sq_modes,
        pll_freq=None if front is None else front.pll.freq,
        resamp_credit=None,  # integer decimators: no fractional credit
    )
    return new_state, (audio, metrics)


class ReceiverBank:
    """Stateful multi-channel bank over shared-IQ blocks, on ``device`` (the
    card unless the caller asks for the CPU). After each call ``metrics``
    holds the block's BlockMetrics. ``backend`` is 'kernel' (the port's
    default), its JAX name 'pallas', or 'xla' (bank_step says what each
    runs); ``input_format`` 'c64', 'i16' or 'u8'."""

    def __init__(self, cfg: BankConfig, block_len: int = 1_000_000,
                 backend: str = "kernel", input_format: str = "c64", *,
                 device="cuda"):
        D = cfg.decim1 * cfg.decim2
        if block_len % D:
            raise ValueError(f"block_len must be a multiple of {D}")
        self.cfg = cfg
        self.block_len = block_len
        self.backend = _check_back_end(False, backend)
        self.input_format = input_format
        self.params, self.state = build(cfg, input_format, device=device)
        self.metrics = None

    @property
    def device(self) -> torch.device:
        return self.params.taps_re.device

    def __call__(self, iq):
        iq = check_input(iq, self.input_format, self.device)
        with annotate("ReceiverBank.step"):
            self.state, (audio, metrics) = bank_step(
                self.params, self.state, iq, cfg=self.cfg, backend=self.backend)
        self.metrics = metrics
        return audio

