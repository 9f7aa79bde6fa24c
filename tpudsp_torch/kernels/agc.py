"""AGC state and the squelch FSM (port of ``tpudsp/kernels/agc.py``).

Per sample, the AGC gain loop is

    y        = x * g
    y2p      = (1 - alpha) * y2p + alpha * |y|^2
    g       *= exp(-alpha/2 * ln(y2p))       (unless locked; clamped to 1e6)
    rssi     = -20 log10 g
    FSM step on (rssi > threshold)
    output   = 0 in states ENABLED(1) / SIGNALLO(5), else y * scale

This module holds the plain PyTorch versions: the step (``sample_step``,
which the fused AM front ``kernels/am_backend.front_sample_step`` also
runs), the exact scan ``agc_apply`` and the chunk-parallel
``agc_apply_chunked``. On the card the three routes of the AGC op launch
the CUDA kernel ``csrc/agc_scan.cu`` instead (``cuda/agc_scan``).

The chunked AGC is an approximation: each chunk re-derives its entry state
from the ``warmup`` samples before it, with a relative error of about
exp(-alpha * warmup / 3) (kernels/warmup.py). Its result depends on
``chunk`` and ``warmup``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lanes

# Squelch states -- numbering is the reference's documented contract.
SQ_UNKNOWN = 0
SQ_ENABLED = 1
SQ_RISE = 2
SQ_SIGNALHI = 3
SQ_FALL = 4
SQ_SIGNALLO = 5
SQ_TIMEOUT = 6
SQ_DISABLED = 7


class AgcState(NamedTuple):
    g: torch.Tensor          # f32, linear gain
    y2p: torch.Tensor        # f32, smoothed output power
    sq_mode: torch.Tensor    # i32, squelch FSM state
    sq_timer: torch.Tensor   # i32, SIGNALLO countdown


class AgcParams(NamedTuple):
    alpha: torch.Tensor      # f32, loop bandwidth
    locked: torch.Tensor     # bool, freeze gain updates
    squelch: torch.Tensor    # bool, squelch enabled
    threshold: torch.Tensor  # f32, squelch threshold dB
    timeout: torch.Tensor    # i32, SIGNALLO -> TIMEOUT countdown
    scale: torch.Tensor      # f32, output scale


def agc_init(squelch: bool = False, timeout: int = 100,
             device=None) -> AgcState:
    return AgcState(
        g=torch.tensor(1.0, dtype=torch.float32, device=device),
        y2p=torch.tensor(1.0, dtype=torch.float32, device=device),
        sq_mode=torch.tensor(SQ_ENABLED if squelch else SQ_DISABLED,
                             dtype=torch.int32, device=device),
        sq_timer=torch.tensor(timeout, dtype=torch.int32, device=device),
    )


def make_params(alpha=0.01, locked=False, squelch=False, threshold=0.0,
                timeout=100, scale=1.0, device=None) -> AgcParams:
    f32 = dict(dtype=torch.float32, device=device)
    return AgcParams(
        alpha=torch.tensor(alpha, **f32),
        locked=torch.tensor(locked, dtype=torch.bool, device=device),
        squelch=torch.tensor(squelch, dtype=torch.bool, device=device),
        threshold=torch.tensor(threshold, **f32),
        timeout=torch.tensor(timeout, dtype=torch.int32, device=device),
        scale=torch.tensor(scale, **f32),
    )


def _fsm_step(mode, timer, high, timeout, squelch_on):
    """One squelch FSM transition, branch-free, in the JAX package's update
    order: the timer is reset on FALL, then decremented in SIGNALLO, and
    the decremented value decides TIMEOUT."""
    is_ = lambda m: mode == m
    next_mode = mode
    next_mode = torch.where(is_(SQ_UNKNOWN) | is_(SQ_ENABLED),
                            torch.where(high, SQ_RISE, SQ_ENABLED), next_mode)
    next_mode = torch.where(is_(SQ_RISE),
                            torch.where(high, SQ_SIGNALHI, SQ_FALL), next_mode)
    next_mode = torch.where(is_(SQ_SIGNALHI) & ~high, SQ_FALL, next_mode)
    next_mode = torch.where(is_(SQ_FALL),
                            torch.where(high, SQ_SIGNALHI, SQ_SIGNALLO),
                            next_mode)
    timer = torch.where(is_(SQ_FALL) & ~high, timeout, timer)
    in_lo = is_(SQ_SIGNALLO)
    timer = torch.where(in_lo & ~high, timer - 1, timer)
    next_mode = torch.where(
        in_lo,
        torch.where(high, SQ_SIGNALHI,
                    torch.where(timer <= 0, SQ_TIMEOUT, SQ_SIGNALLO)),
        next_mode)
    next_mode = torch.where(is_(SQ_TIMEOUT), SQ_ENABLED, next_mode)
    next_mode = torch.where(squelch_on, next_mode, SQ_DISABLED)
    return next_mode.to(torch.int32), timer.to(torch.int32)


def sample_step(p: AgcParams, st: AgcState, xr, xi):
    """One AGC + squelch step on f32 re/im samples (scalars or lane
    vectors). Returns (state, (out_re, out_im, mode)): the output is
    x * g * scale, zeroed in ENABLED / SIGNALLO."""
    g, y2p, mode, timer = st
    yr = xr * g
    yi = xi * g
    y2 = yr * yr + yi * yi
    y2p = (1.0 - p.alpha) * y2p + p.alpha * y2
    g_new = torch.clamp_max(
        g * torch.exp(-0.5 * p.alpha * torch.log(y2p + 1e-30)), 1e6)
    g = torch.where(p.locked, g, g_new)
    rssi = -20.0 * torch.log10(torch.clamp_min(g, 1e-30))
    high = rssi > p.threshold
    mode, timer = _fsm_step(mode, timer, high, p.timeout, p.squelch)
    zero = (mode == SQ_ENABLED) | (mode == SQ_SIGNALLO)
    outr = torch.where(zero, 0.0, yr * p.scale)
    outi = torch.where(zero, 0.0, yi * p.scale)
    return AgcState(g, y2p, mode, timer), (outr, outi, mode)


def _step(p: AgcParams):
    return lambda st, xr, xi: sample_step(p, st, xr, xi)


def agc_apply(params: AgcParams, state: AgcState, x):
    """Exact sequential AGC over the last axis of x (..., N) complex64, state
    leaves shaped like x[..., 0]: a Python loop over the samples. Returns
    (state, (y complex64, modes i32)) shaped like x."""
    state, (yr, yi, modes) = lanes.exact_scan(_step(params), state, x)
    return state, (torch.complex(yr, yi), modes)


def agc_chunked_lanes(params: AgcParams, state: AgcState, x, chunk: int,
                      warmup: int, tail: str):
    """Chunk-parallel AGC over x (C, L) complex64 from per-stream state
    leaves (C,), for L > chunk + warmup. A padded last chunk gets each
    stream's carried state re-derived exactly from its unpadded tail,
    starting from the last chunk's warmup-derived entry state
    (tail='entry', kernels/agc.py's agc_apply_chunked) or from the previous
    chunk's final state (tail='prev', pallas/agc_scan.py's wrapper).
    Returns (state (C,), (y (C, L), modes (C, L)))."""
    C, L = x.shape
    entry, final, (yr, yi, modes), nchunks, pad = lanes.chunked_scan(
        _step(params), state, x, chunk, warmup)
    new_state = lanes.per_stream(final, C, -1)
    if pad:
        start = entry if tail == "entry" else final
        k = -1 if tail == "entry" else -2
        new_state, _ = agc_apply(params, lanes.per_stream(start, C, k),
                                 x[:, (nchunks - 1) * chunk:])
    y = torch.complex(lanes.unplanes(yr, C, L), lanes.unplanes(yi, C, L))
    return new_state, (y, lanes.unplanes(modes, C, L))


def agc_apply_chunked(params: AgcParams, state: AgcState, x, chunk: int,
                      warmup: int, tail: str = "entry"):
    """Throughput AGC over x (N,) with scalar state, or a batch x (C, N)
    with state leaves (C,): chunks run in parallel, each warmed up on the
    ``warmup`` samples before it (``agc_chunked_lanes``; ``tail`` picks the
    padded last chunk's fix). A block with N <= chunk + warmup runs
    exactly. Returns (state, (y, modes)) shaped like the input."""
    if x.shape[-1] <= chunk + warmup:
        return agc_apply(params, state, x)
    if x.ndim == 2:
        return agc_chunked_lanes(params, state, x, chunk, warmup, tail)
    st, (y, modes) = agc_chunked_lanes(params, lanes.one_stream(state),
                                       x[None], chunk, warmup, tail)
    return lanes.first_stream(st), (y[0], modes[0])
