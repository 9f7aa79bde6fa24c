"""AGC state and the squelch FSM (port of ``tpudsp/kernels/agc.py``).

Per sample, the AGC gain loop is

    y        = x * g
    y2p      = (1 - alpha) * y2p + alpha * |y|^2
    g       *= exp(-alpha/2 * ln(y2p))       (unless locked; clamped to 1e6)
    rssi     = -20 log10 g
    FSM step on (rssi > threshold)
    output   = 0 in states ENABLED(1) / SIGNALLO(5), else y * scale

The port runs it only inside the fused AM front
(``kernels/am_backend.front_sample_step`` and its CUDA kernel); this module
holds the state, the parameters and the FSM transition they share.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
