"""Combined AM-chain back end: AGC -> carrier PLL -> DC tracker ->
de-emphasis (port of ``tpudsp/kernels/am_backend.py``).

Per sample (x complex input at the pcm rate):
    y      = x * g                        (AGC gain)
    y2p    = (1-alpha) y2p + alpha |y|^2
    g     *= exp(-alpha/2 ln y2p)         (unless locked; clamped 1e6)
    FSM step on rssi = -20 log10 g;  out0 = 0 in ENABLED/SIGNALLO else y*scale
    v      = out0 * e^{-j theta}          (carrier PLL; identity if no carrier)
    err    = patan2(Im v, Re v)
    freq  += pll_alpha * err; theta += pll_beta * err + freq (wrapped)
    m_raw  = Re v
    dc     = rho dc + (1-rho) m_raw
    audio  = (m_raw - dc) / mod
    pcm    = b0 * audio + a * pcm_prev    (de-emphasis)

The FEEDBACK part (AGC + PLL, ``front_sample_step``) is what the CUDA
kernel ``csrc/am_front_scan.cu`` runs per lane; this module holds its
plain PyTorch version. The phase error uses ``patan2``, the polynomial the
TPU kernel uses, in both (the JAX package's XLA path uses libm atan2;
which one the port should settle on is an open ROADMAP item).

The two LINEAR stages (DC tracker, de-emphasis) run after the front as
blocked first-order scans: ``kernels/iir.linear_tail`` is their plain
version, ``cuda/first_order.linear_tail`` the one launch of the CUDA
kernel ``csrc/first_order_scan.cu`` that runs them on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import agc as kagc
from . import lanes
from .agc import AgcParams, AgcState
from .ampmodem import DC_RHO, PLL_BW
from .fastmath import patan2
from .pll import PllState, wrap


class AmBackendState(NamedTuple):
    agc: AgcState
    pll: PllState
    dc: torch.Tensor      # f32
    deemph: torch.Tensor  # f32


class AmBackendParams(NamedTuple):
    """Feedback-loop values are f32 tensors on the chain's device. The
    linear stages' coefficients (dc_rho, deemph_b0, deemph_a) stay Python
    floats, the float64 design values: the blocked scans fold them on the
    host, as the JAX package's XLA back end does."""
    agc: AgcParams
    pll_alpha: torch.Tensor
    pll_beta: torch.Tensor
    use_pll: torch.Tensor   # f32 1.0/0.0 (carrier present / suppressed)
    use_dc: torch.Tensor    # f32 1.0/0.0 (DC tracking only with carrier)
    inv_mod: torch.Tensor
    dc_rho: float
    deemph_b0: float
    deemph_a: float


def make_params(agc_params: AgcParams, mod_index, deemph_b0: float,
                deemph_a: float, carrier: bool, pll_bw: float = PLL_BW,
                dc_rho: float = DC_RHO) -> AmBackendParams:
    """Constants are filled on the AGC parameters' device (no host copy)."""
    dev = agc_params.alpha.device
    full = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    mod = torch.as_tensor(mod_index, dtype=torch.float32, device=dev)
    return AmBackendParams(
        agc=agc_params,
        pll_alpha=full(float(np.float32(pll_bw))),
        pll_beta=full(float(np.float32(np.sqrt(pll_bw)))),
        use_pll=full(1.0 if carrier else 0.0),
        use_dc=full(1.0 if carrier else 0.0),
        inv_mod=full(1.0) / mod,
        dc_rho=float(dc_rho),
        deemph_b0=float(deemph_b0),
        deemph_a=float(deemph_a),
    )


def init_state(device=None) -> AmBackendState:
    zero = lambda: torch.tensor(0.0, dtype=torch.float32, device=device)
    return AmBackendState(agc=kagc.agc_init(device=device),
                          pll=PllState(zero(), zero()), dc=zero(),
                          deemph=zero())


class FrontState(NamedTuple):
    agc: AgcState
    pll: PllState


def front_sample_step(p: AmBackendParams, st: FrontState, xr, xi):
    """The FEEDBACK part only (AGC + carrier PLL) -> per-sample vr = Re(v)
    and the squelch mode. Works on scalars or lane vectors."""
    agc, (outr, outi, mode) = kagc.sample_step(p.agc, st.agc, xr, xi)
    theta, freq = st.pll
    c = torch.cos(theta)
    s = torch.sin(theta)
    vr = outr * c + outi * s
    vi = outi * c - outr * s
    err = patan2(vi, vr) * p.use_pll
    freq = freq + p.pll_alpha * err
    theta = wrap(theta + p.pll_beta * err + freq)
    return FrontState(agc, PllState(theta, freq)), (vr, mode)


def front_exact(p: AmBackendParams, st: FrontState, x):
    """Exact sequential AGC+PLL front: the plain version, a Python loop over
    the samples on the last axis. x: (..., N) complex64 with state leaves
    shaped like x[..., 0]. Returns (FrontState, (vr, modes)) shaped like x.
    (``cuda/am_backend_scan.front_exact`` runs it as a kernel on CUDA.)"""
    return lanes.exact_scan(lambda s, xr, xi: front_sample_step(p, s, xr, xi),
                            st, x)


def front_chunked(p: AmBackendParams, st: FrontState, x, chunk: int,
                  warmup: int):
    """Chunk-parallel AGC+PLL front over a 1-D block x (N,) complex64 with
    scalar state: a one-stream batch of ``cuda/am_backend_scan.front_chunked``
    (its CUDA kernel on a CUDA tensor, its plain version on the CPU).
    Derive ``warmup`` with kernels/warmup.warmup_for."""
    # imported here: cuda/am_backend_scan imports this module
    from ..cuda.am_backend_scan import front_chunked as batched
    front, (vr, modes) = batched(p, lanes.one_stream(st), x[None], chunk,
                                 warmup)
    return lanes.first_stream(front), (vr[0], modes[0])


def sample_step(p: AmBackendParams, st: AmBackendState, xr, xi):
    """One combined step (front + DC tracker + de-emphasis), all in f32
    with the f32-rounded linear coefficients (the JAX package's serial
    reference)."""
    front, (vr, mode) = front_sample_step(p, FrontState(st.agc, st.pll), xr, xi)
    f32 = lambda v: float(np.float32(v))
    rho = f32(p.dc_rho)
    dc = rho * st.dc + f32(np.float32(1.0) - np.float32(rho)) * vr
    audio = (vr - dc * p.use_dc) * p.inv_mod
    pcm = f32(p.deemph_b0) * audio + f32(p.deemph_a) * st.deemph
    return AmBackendState(front.agc, front.pll, dc, pcm), (pcm, mode)


def am_backend_exact(p: AmBackendParams, st: AmBackendState, x):
    """Exact sequential combined back end, a Python loop over x (N,)
    complex64. Returns (state, (pcm, modes))."""
    return lanes.exact_scan(lambda s, xr, xi: sample_step(p, s, xr, xi),
                            st, x)

