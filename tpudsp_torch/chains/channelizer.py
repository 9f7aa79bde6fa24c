"""Critically sampled or 2x oversampled polyphase FFT channelizer and its
demod bank (port of ``tpudsp/chains/channelizer.py``, BASELINE config 4:
1024 channels at 100 Msps).

The analysis bank: with C channels, T taps a branch and hop R = C / os,
branch p of frame m accumulates

    u[m, p] = sum_t Ht[t, p] xfull[(m + os (T-1-t)) R + C-1-p]

over the carried raw samples and the block (xfull = tail ++ x), then a
C-point IFFT along the branches gives the (M, C) channel matrix at rate
os fs / C a channel (with the parity sign of the oversampled hop). On the
card the branch sum is one launch of the CUDA kernel ``csrc/pfb_branch.cu``
(``cuda/pfb``; CPU tensors take its plain version ``kernels/pfb``), which
reads the tail and the block in place; the IFFT is ``torch.fft``. The
'conv' engine, which the JAX package keeps as an experiment, is one
depthwise dilated conv1d over the frame matrix.

The demod bank runs on the channels: the uniform-FM bank on the
channelizer's (M, C) layout directly (the discriminator, then the
de-emphasis down the columns: the f32 audio transposed and one
``csrc/first_order_scan.cu`` launch over its C rows), the others
on the (C, M) rows (envelope AM; the coherent AM channels' AGC + carrier
PLL in one ``csrc/am_front_scan.cu`` launch and their DC tracker in one
first_order_scan launch; the de-emphasis of the C rows in one more).

``bank_step`` only enqueues device work: it reads no value of a device
tensor on the host.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..cuda import first_order, pfb
from ..cuda.am_backend_scan import front_chunked
from ..design import firdes, iirdes
from ..kernels import agc as kagc
from ..kernels import am_backend as kab
from ..kernels import ampmodem as kam
from ..kernels import f32_conv1d
from ..kernels import pfb as kpfb
from ..kernels import warmup as kwarm
from ..kernels.fastmath import patan2
from ..kernels.pll import PllState
from ..utils.profiling import annotate
from . import metrics as kmet
from .am import INPUT_FORMATS, _check_back_end
from .bank import KERNEL_CHUNK, _fm_base, _index_tensor, check_input
from .metrics import BlockMetrics

TWO_PI = 2.0 * np.pi


@dataclass(frozen=True)
class ChannelizerConfig:
    nchan: int = 1024
    taps_per_branch: int = 12
    iq_rate: float = 100_000_000.0
    As: float = 60.0
    # prototype cutoff as a fraction of the channel spacing (slightly wider
    # than 0.5 keeps each channel's passband flat)
    cutoff_frac: float = 0.55
    # 1 = critically sampled (channel rate fs/C); 2 = 2x oversampled (hop
    # C/2, channel rate 2 fs/C: the channel's Nyquist band spans the whole
    # channel spacing)
    oversample: int = 1
    # the branch sum: 'shift' (the JAX package's engine: on the card the
    # pfb_branch kernel) or 'conv' (one depthwise dilated conv1d, the JAX
    # package's experiment, equality-pinned)
    engine: str = "shift"

    def __post_init__(self):
        if self.oversample not in (1, 2):
            raise ValueError("oversample must be 1 or 2")
        if self.oversample == 2 and self.nchan % 2:
            raise ValueError("2x oversampling needs an even channel count")
        if self.engine not in ("shift", "conv"):
            raise ValueError("engine must be 'shift' or 'conv'")

    @property
    def chan_rate(self):
        return self.iq_rate / self.nchan * self.oversample


class ChannelizerState(NamedTuple):
    tail: torch.Tensor  # ((T-1) C + C-1,) complex64, or raw (.., 2): carried samples


def build(cfg: ChannelizerConfig, input_format: str = "c64", device="cuda"):
    """(Ht (T, C) f32, the initial state) on ``device`` (the card unless the
    caller asks for the CPU). Ht[t, p] = h[t C + p] of the Kaiser prototype
    at unity passband gain; 'i16' folds 1/32767 into it and keeps a raw
    int16 tail, 'u8' (RTL-SDR, (b - 127.5)/127.5) folds 1/127.5 and keeps a
    raw uint8 tail started at 127."""
    if input_format not in INPUT_FORMATS:
        raise ValueError(f"unknown input_format {input_format!r} "
                         "(use 'c64', 'i16' or 'u8')")
    C, T = cfg.nchan, cfg.taps_per_branch
    h = firdes.kaiser_lowpass(C * T, cfg.cutoff_frac / C, cfg.As)
    h = h / h.sum()
    if input_format == "i16":
        h = h * (1.0 / 32767.0)
    elif input_format == "u8":
        h = h * (1.0 / 127.5)
    Ht = torch.tensor(h.reshape(T, C), dtype=torch.float32, device=device)
    htail = (T - 1) * C + C - 1
    if input_format == "i16":
        tail = torch.zeros((htail, 2), dtype=torch.int16, device=device)
    elif input_format == "u8":
        # 127 ~ zero signal to within half an LSB
        tail = torch.full((htail, 2), 127, dtype=torch.uint8, device=device)
    else:
        tail = torch.zeros((htail,), dtype=torch.complex64, device=device)
    return Ht, ChannelizerState(tail=tail)


def _branch_accumulate_conv(Ht, V, M: int, os: int):
    """The branch sum as one depthwise dilated convolution along the frame
    axis (groups C, window T, dilation os):

        u[m, p] = sum_k K[k, p] V[m + os k, p],   K[k, p] = Ht[T-1-k, p]

    V: (M_all, C) f32 or complex64 (the re and im planes as a batch of
    two). Returns (M, C) of V's type."""
    T, C = Ht.shape
    K = Ht.flip(0).T.reshape(C, 1, T).contiguous()
    planes = torch.view_as_real(V) if V.is_complex() else V[..., None]
    out = f32_conv1d(planes.float().permute(2, 1, 0).contiguous(), K, dilation=os, groups=C)
    u = out.permute(2, 1, 0)[:M]
    return torch.view_as_complex(u.contiguous()) if V.is_complex() else u[..., 0]


@functools.lru_cache(maxsize=16)
def _parity_sign(C: int, device: torch.device):
    """(-1)^c over the channels, f32 (C,), made once a device."""
    return (1.0 - 2.0 * (torch.arange(C, device=device) % 2)).float()


def _channelize(Ht, state: ChannelizerState, x, os: int, engine: str):
    T, C = Ht.shape
    M = x.shape[0] * os // C
    if engine == "conv":
        V = torch.cat([state.tail, x])[kpfb.frame_index(M, T, C, os, x.device)]
        if V.is_complex():
            u = _branch_accumulate_conv(Ht, V, M, os)
        else:
            ur = _branch_accumulate_conv(Ht, V[..., 0].float(), M, os)
            ui = _branch_accumulate_conv(Ht, V[..., 1].float(), M, os)
            if x.dtype == torch.uint8:
                dc = 127.5 * kpfb.branch_sums(Ht)
                ur, ui = ur - dc, ui - dc
            u = torch.complex(ur, ui)
    else:
        u = pfb.branch_accumulate(Ht, state.tail, x, os)
    # the IFFT times C: the unscaled inverse transform
    Y = torch.fft.ifft(u, dim=1, norm="forward")
    if os == 2:
        # (-1)^(c m): the oversampled hop's phase, a sign on odd frames
        Y[1::2] *= _parity_sign(C, Y.device)
    htail = state.tail.shape[0]
    tail = torch.cat([state.tail, x[-htail:]])[-htail:]
    return ChannelizerState(tail=tail), Y


def channelize(Ht, state: ChannelizerState, x, os: int = 1, engine: str = "shift"):
    """x: (N,) complex64, N a multiple of C. Returns (state, Y (M, C)
    complex64): M = os N / C frames of C channel samples; channel c is the
    signal at centre +c/C cycles a sample, at unity prototype-passband
    gain. Hop R = C / os: Y[m, c] = sum_n x[n] e^{-2 pi j c n / C} h[m R -
    n] (mix down, filter, sample every R), i.e. the branch sum over the
    commutator read backwards, a C-point IFFT (times C) along the branches
    and, at os = 2, the sign (-1)^(c m)."""
    return _channelize(Ht, state, x, os, engine)


def channelize_i16(Ht, state: ChannelizerState, x2, os: int = 1, engine: str = "shift"):
    """``channelize`` for raw wire input: x2 (N, 2) [re, im] int16 (Ht
    carrying 1/32767, build(input_format='i16')) or RTL-SDR uint8 (Ht
    carrying 1/127.5, build(input_format='u8'): the -127.5 offset is the
    per-branch constant 127.5 sum_t Ht[t, p], subtracted from both parts
    before the IFFT). The components convert to f32 at the product."""
    return _channelize(Ht, state, x2, os, engine)


class Channelizer:
    """Stateful analysis channelizer over fixed-size blocks, on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: ChannelizerConfig = ChannelizerConfig(),
                 block_len: int = 1 << 20, *, device="cuda"):
        if block_len % cfg.nchan:
            raise ValueError("block_len must be a multiple of nchan")
        self.cfg = cfg
        self.block_len = block_len
        self.Ht, self.state = build(cfg, device=device)

    @property
    def device(self) -> torch.device:
        return self.Ht.device

    def __call__(self, iq):
        iq = torch.as_tensor(iq, device=self.device).to(torch.complex64).contiguous()
        self.state, Y = channelize(self.Ht, self.state, iq, os=self.cfg.oversample,
                                   engine=self.cfg.engine)
        return Y


class DemodBankState(NamedTuple):
    ch: ChannelizerState
    fd_prev: torch.Tensor  # (C,) complex64
    deemph: torch.Tensor   # (C,) f32
    front: object = None   # FrontState (Ca,) when cfg.am_coherent
    dc: object = None      # (Ca,) f32 DC-tracker carry (coherent AM)


@dataclass(frozen=True)
class ChannelizedBankConfig:
    channelizer: ChannelizerConfig = ChannelizerConfig()
    # 'fm' | 'am' uniform, or a per-channel tuple of them (run branch-free:
    # masks over the batched bases, the coherent back end on its AM rows)
    demod: object = "fm"
    kd: float = 0.3125     # at the channel rate
    deemph_tau: float = 75e-6
    # the coherent back end for demod='am' (AGC + carrier PLL + DC tracker)
    # instead of the raw envelope
    am_coherent: bool = False
    agc_bandwidth: float = 0.01
    agc_scale: float = 1.0
    modulation: float = 1.0

    def __post_init__(self):
        if isinstance(self.demod, str):
            if self.demod not in ("fm", "am"):
                raise ValueError(f"unknown demod {self.demod!r} (use 'fm' or 'am')")
        else:
            d = tuple(self.demod)
            object.__setattr__(self, "demod", d)
            if len(d) != self.channelizer.nchan:
                raise ValueError(f"demod tuple length {len(d)} != nchan "
                                 f"{self.channelizer.nchan}")
            bad = sorted({x for x in d if x not in ("fm", "am")})
            if bad:
                raise ValueError(f"unknown demod(s) {bad} (use 'fm'/'am')")


def _demod_tuple(cfg: ChannelizedBankConfig):
    d = cfg.demod
    return (d,) * cfg.channelizer.nchan if isinstance(d, str) else d


def _am_indices(cfg: ChannelizedBankConfig):
    return tuple(i for i, d in enumerate(_demod_tuple(cfg)) if d == "am")


def _is_mixed(cfg: ChannelizedBankConfig):
    d = _demod_tuple(cfg)
    return any(x != d[0] for x in d)


def bank_build(cfg: ChannelizedBankConfig, input_format: str = "c64", device="cuda"):
    """(params, init_state) on ``device``: params = (Ht, b0, a, amb,
    fm_mask) as the JAX package's (b0, a the de-emphasis at the channel
    rate, f32; amb the coherent AM back end's parameters or None; fm_mask
    (C,) bool for a mixed bank, else None)."""
    Ht, ch_state = build(cfg.channelizer, input_format, device=device)
    C = cfg.channelizer.nchan
    b0, a = iirdes.deemphasis_coeffs(cfg.channelizer.chan_rate, cfg.deemph_tau)
    front = dc0 = amb = None
    am_idx = _am_indices(cfg)
    fm_mask = (None if not _is_mixed(cfg) else
               torch.tensor([d == "fm" for d in _demod_tuple(cfg)], device=device))
    if am_idx and cfg.am_coherent:
        Ca = len(am_idx)
        amb = kab.make_params(
            kagc.make_params(alpha=cfg.agc_bandwidth, scale=cfg.agc_scale, device=device),
            cfg.modulation, b0, a, carrier=True)
        zeros = lambda: torch.zeros((Ca,), dtype=torch.float32, device=device)
        front = kab.FrontState(
            agc=kagc.AgcState(*(v.expand(Ca).contiguous() for v in kagc.agc_init(device=device))),
            pll=PllState(zeros(), zeros()))
        dc0 = zeros()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    params = (Ht, f32(b0), f32(a), amb, fm_mask)
    state = DemodBankState(
        ch=ch_state,
        fd_prev=torch.full((C,), 1.0 + 0.0j, dtype=torch.complex64, device=device),
        deemph=torch.zeros((C,), dtype=torch.float32, device=device),
        front=front, dc=dc0)
    return params, state


def bank_step(params, state: DemodBankState, x, *, cfg: ChannelizedBankConfig,
              backend: str = "xla"):
    """100 Msps IQ block -> (state, (audio (C, M) f32, BlockMetrics)):
    channelize, then demodulate every channel (discriminator + de-emphasis
    for FM; envelope or the coherent AGC + PLL + DC back end for AM).
    ``backend`` sets the coherent AM channels' chunk and warmup: both run
    csrc/am_front_scan.cu over the Ca streams in one launch, 'kernel' (or
    'pallas') with the JAX package's Pallas chunk (KERNEL_CHUNK) while the
    warmup fits its cap, 'xla' with its XLA chunk (warmup.chunk_for)."""
    backend = _check_back_end(False, backend)
    Ht, _, _, amb, fm_mask = params
    with annotate("bank_step.channelize"):
        ch_state, Y = _channelize(Ht, state.ch, x, cfg.channelizer.oversample,
                                  cfg.channelizer.engine)   # (M, C)
    mixed = _is_mixed(cfg)
    if not mixed and _demod_tuple(cfg)[0] == "fm":
        # the uniform-FM bank on the channelizer's (M, C) layout: the
        # discriminator down the columns, then the de-emphasis down the
        # columns, which transposes the f32 audio into its (C, M) rows
        with annotate("bank_step.demod"):
            b0_de, a_de = iirdes.deemphasis_coeffs(cfg.channelizer.chan_rate,
                                                   cfg.deemph_tau)
            prev = torch.cat([state.fd_prev[None, :], Y[:-1]], 0)
            d = Y * torch.conj(prev)
            base_mc = patan2(d.imag, d.real) / float(np.float32(TWO_PI * cfg.kd))
            deemph, audio_mc = first_order.first_order_apply_blocked_mc(
                b0_de, a_de, state.deemph, base_mc)
        metrics = BlockMetrics(rssi=None, squelch_modes=None, pll_freq=None,
                               resamp_credit=None)
        audio = audio_mc.T.contiguous()
        return (DemodBankState(ch_state, Y[-1].clone(), deemph, state.front, state.dc),
                (audio, metrics))
    Yc = Y.T.contiguous()                          # (C, M)
    fd_prev = Yc[:, -1].clone()
    front, dc = state.front, state.dc
    sq_modes = None
    am_idx = _am_indices(cfg)

    def coherent(y, front0, dc0):
        w = kwarm.warmup_for(agc_alpha=cfg.agc_bandwidth, pll_bw=kam.PLL_BW)
        chunk = (KERNEL_CHUNK if backend == "kernel" and w <= kwarm.PALLAS_WARMUP_MAX
                 else kwarm.chunk_for(w))
        fr, (vr, modes) = front_chunked(amb, front0, y, chunk, w)
        dc2, dct = first_order.first_order_apply_blocked(
            1.0 - kam.DC_RHO, kam.DC_RHO, dc0, vr)
        return fr, dc2, (vr - dct) * amb.inv_mod, modes

    with annotate("bank_step.demod"):
        b0_de, a_de = iirdes.deemphasis_coeffs(cfg.channelizer.chan_rate, cfg.deemph_tau)
        if not mixed and cfg.am_coherent:
            front, dc, base, sq_modes = coherent(Yc, state.front, state.dc)
        elif not mixed:
            base = torch.abs(Yc)
        else:
            base = torch.where(fm_mask[:, None], _fm_base(Yc, state.fd_prev, cfg.kd),
                               torch.abs(Yc))
            if cfg.am_coherent and am_idx:
                idx = _index_tensor(am_idx, Yc.device)
                front, dc, coh, sq_modes = coherent(Yc.index_select(0, idx), state.front,
                                                    state.dc)
                base = base.index_copy(0, idx, coh)
        # the de-emphasis over the C rows: one launch
        deemph, audio = first_order.first_order_apply_blocked(b0_de, a_de, state.deemph,
                                                              base)
    metrics = BlockMetrics(
        rssi=None if front is None else kmet.rssi_db(front.agc.g),
        squelch_modes=sq_modes,
        pll_freq=None if front is None else front.pll.freq,
        resamp_credit=None)
    return DemodBankState(ch_state, fd_prev, deemph, front, dc), (audio, metrics)


class ChannelizedBank:
    """Stateful channelized demod bank over fixed-size blocks, on ``device``
    (the card unless the caller asks for the CPU). After each call
    ``metrics`` holds the block's BlockMetrics. ``backend`` is 'xla' (the
    JAX package's default), 'pallas' or its port name 'kernel' (bank_step
    says what each runs); ``input_format`` 'c64', 'i16' or 'u8'."""

    def __init__(self, cfg: ChannelizedBankConfig = ChannelizedBankConfig(),
                 block_len: int = 1 << 20, backend: str = "xla",
                 input_format: str = "c64", *, device="cuda"):
        if block_len % cfg.channelizer.nchan:
            raise ValueError("block_len must be a multiple of nchan")
        self.cfg = cfg
        self.block_len = block_len
        self.backend = _check_back_end(False, backend)
        self.input_format = input_format
        self.params, self.state = bank_build(cfg, input_format, device=device)
        self.metrics = None

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def __call__(self, iq):
        with annotate("ChannelizedBank.step"):
            iq = check_input(iq, self.input_format, self.device)
            self.state, (audio, metrics) = bank_step(
                self.params, self.state, iq, cfg=self.cfg, backend=self.backend)
            self.metrics = metrics
            return audio
