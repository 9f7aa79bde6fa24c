"""Carrier-PLL state and scans, and FMStereo's pilot recovery (port of
``tpudsp/kernels/pll.py``: the carrier scans ``pll_carrier_scan`` and
``pll_carrier_scan_chunked``; ``stereo_pilot_init``,
``stereo_pilot_apply`` and ``stereo_matrix_lowpass``).

Gains follow the liquid nco convention: freq gain alpha = bw, phase gain
beta = sqrt(bw). Per sample (pll.py's update order):

    v      = x e^{-j theta}     (xr cos + xi sin, xi cos - xr sin)
    err    = atan2(Im v, Re v)  (libm atan2, as the JAX scan)
    output theta                (the value BEFORE the update)
    freq  += alpha err
    theta  = wrap(theta + beta err + freq)

This module holds the plain PyTorch versions (a Python loop over the
samples); on the card the scans are the CUDA kernel ``csrc/pll_scan.cu``
(``cuda/pll_scan``). The fused AM front runs the same loop with the
polynomial atan2 inside ``kernels/am_backend.front_sample_step``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..cuda import first_order
from . import fir, lanes, nco
from .warmup import chunk_for, warmup_for


class PllState(NamedTuple):
    theta: torch.Tensor  # f32, radians (wrapped)
    freq: torch.Tensor   # f32, radians/sample


def pll_init(device=None) -> PllState:
    zero = dict(dtype=torch.float32, device=device)
    return PllState(theta=torch.tensor(0.0, **zero),
                    freq=torch.tensor(0.0, **zero))


def wrap(t):
    """Floor-mod into [-pi, pi) with the divisor's sign, as jnp.mod
    (torch.fmod keeps the dividend's)."""
    return torch.remainder(t + math.pi, 2.0 * math.pi) - math.pi


def gains(bw: float):
    """(alpha, beta) = (bw, sqrt(bw)) rounded to f32, as Python floats."""
    return float(np.float32(bw)), float(np.float32(np.sqrt(bw)))


def pll_step(alpha: float, beta: float, st: PllState, xr, xi):
    """One carrier-PLL step on f32 re/im samples (scalars or lane vectors).
    Returns (state, (theta before the update,))."""
    theta, freq = st
    c = torch.cos(theta)
    s = torch.sin(theta)
    vr = xr * c + xi * s
    vi = xi * c - xr * s
    err = torch.atan2(vi, vr)
    freq = freq + alpha * err
    return PllState(wrap(theta + beta * err + freq), freq), (theta,)


def _step(bw: float):
    alpha, beta = gains(bw)
    return lambda st, xr, xi: pll_step(alpha, beta, st, xr, xi)


def pll_carrier_scan(state: PllState, x, bw: float):
    """Exact carrier scan over the last axis of x (..., N) complex64, state
    leaves shaped like x[..., 0]. Returns (state, thetas) shaped like x."""
    state, (thetas,) = lanes.exact_scan(_step(bw), state, x)
    return state, thetas


def chunked_lanes(state: PllState, x, bw: float, chunk: int, warmup: int):
    """Chunk-parallel carrier scan over x (C, L) complex64 from per-stream
    state leaves (C,), for L > chunk + warmup; a padded last chunk re-runs
    each stream's tail from the last chunk's warmup-derived entry state
    (pll.py's _chunked_scan). Returns (state (C,), thetas (C, L))."""
    C, L = x.shape
    entry, final, (thetas,), nchunks, pad = lanes.chunked_scan(
        _step(bw), state, x, chunk, warmup)
    new_state = lanes.per_stream(final, C, -1)
    if pad:
        new_state, _ = pll_carrier_scan(lanes.per_stream(entry, C, -1),
                                        x[:, (nchunks - 1) * chunk:], bw)
    return new_state, lanes.unplanes(thetas, C, L)


def chunk_plan(bw: float, chunk: int | None, warmup: int | None):
    """pll_carrier_scan_chunked's defaults: warmup from kernels/warmup.py
    (>= 12/sqrt(bw), at least 2048), chunk_for(warmup, base=2048)."""
    if warmup is None:
        warmup = warmup_for(pll_bw=bw, minimum=2048)
    if chunk is None:
        chunk = chunk_for(warmup, base=2048)
    return chunk, warmup


def pll_carrier_scan_chunked(state: PllState, x, bw: float,
                             chunk: int | None = None,
                             warmup: int | None = None):
    """Chunk-parallel carrier scan over x (N,) with scalar state, or a
    batch x (C, N) with state leaves (C,) (an approximation, exact after
    lock to ~exp(-sqrt(bw) warmup)). A block with N <= chunk + warmup runs
    exactly. Returns (state, thetas) shaped like the input."""
    chunk, warmup = chunk_plan(bw, chunk, warmup)
    if x.shape[-1] <= chunk + warmup:
        return pll_carrier_scan(state, x, bw)
    if x.ndim == 2:
        return chunked_lanes(state, x, bw, chunk, warmup)
    st, thetas = chunked_lanes(lanes.one_stream(state), x[None], bw, chunk,
                               warmup)
    return lanes.first_stream(st), thetas[0]


class StereoPilotState(NamedTuple):
    p: torch.Tensor        # c64: first smoothing stage (pilot phasor at DC)
    p2: torch.Tensor       # c64: second smoothing stage (cascade)
    phase_u: torch.Tensor  # int64 in [0, 2^32): running phase of the 19 kHz mixer


def stereo_pilot_init(device=None) -> StereoPilotState:
    zero = torch.zeros((), dtype=torch.complex64, device=device)
    return StereoPilotState(zero, zero.clone(),
                            torch.zeros((), dtype=torch.int64, device=device))


def _onepole_scan(rho: float, carry, v):
    """Complex one-pole p[n] = rho p[n-1] + (1 - rho) v[n] from the carried
    entry: the blocked scan's complex64 entry (cuda/first_order: one launch
    of csrc/first_order_scan.cu on the card)."""
    _, y = first_order.first_order_apply_blocked_c64(1.0 - rho, rho, carry, v)
    return y


def stereo_pilot_apply(state: StereoPilotState, s, dtheta_u: int, rho: float = 0.999,
                       with_metrics: bool = False):
    """FMStereo pilot recovery and L-R subband demodulation, block-parallel
    (the JAX package's pilot-squaring receiver, no sequential PLL):

        z[n]  = s[n] e^{-j w_p n}                (nominal 19 kHz mix, 32-bit NCO)
        p[n]  = onepole(onepole(z))              (a cascade of two one-poles)
        u[n]  = p[n] / |p[n]|                    (unit pilot phasor)
        lr[n] = 2 s[n] Re(u[n]^2 e^{2j w_p n})   (coherent 38 kHz demod)

    s: (N,) float32 composite; dtheta_u: the per-sample pilot phase
    increment in 32-bit units (a host int). Returns (new_state, lr
    float32), and with ``with_metrics`` also (pilot_level, pilot_freq): the
    smoothed pilot amplitude at block end and the amplitude-weighted mean
    rotation of the pilot phasor over the block tail (rad/sample off the
    nominal 19 kHz)."""
    n = s.shape[0]
    theta, phase_u = nco.nco_angles(state.phase_u, dtheta_u, n, s.device)
    osc = torch.polar(torch.ones_like(theta), -theta)
    z = s.to(torch.complex64) * osc
    p1 = _onepole_scan(float(rho), state.p, z)
    p = _onepole_scan(float(rho), state.p2, p1)
    mag = torch.abs(p)
    u = torch.where(mag > 1e-6, p / (mag + 1e-12), torch.zeros_like(p))
    ref38 = u * u * torch.conj(osc) * torch.conj(osc)   # e^{+2j w_p n} u^2
    lr = 2.0 * s * ref38.real
    new_state = StereoPilotState(p=p1[-1], p2=p[-1],
                                 phase_u=phase_u)
    if not with_metrics:
        return new_state, lr.float()
    tail = p[-max(n // 4, 2):]
    rot = tail[1:] * torch.conj(tail[:-1])
    pilot_freq = torch.angle(torch.sum(rot)).float()
    # |p| tracks pilot_amplitude / 2 (one-sided mix of a real tone): report
    # the full pilot amplitude in composite units
    pilot_level = (2.0 * mag[-1]).float()
    return new_state, lr.float(), (pilot_level, pilot_freq)


def stereo_matrix_lowpass(h_aud, tail, s, lr):
    """Audio-band lowpass and stereo matrix in one complex FIR pass over s +
    j lr (real taps, so both paths share one group delay). Returns
    (new_tail, (L, R)) with L = s_f + lr_f, R = s_f - lr_f. Taps from
    design/firdes.stereo_audio_lowpass."""
    tail, c = fir.fir_apply(h_aud, tail, torch.complex(s, lr))
    return tail, (c.real + c.imag, c.real - c.imag)
