"""Fused AM-chain back end on the card: the AGC + squelch + carrier-PLL
feedback core as the CUDA kernel ``csrc/am_front_scan.cu`` (port of
``tpudsp/pallas/am_backend_scan.py``).

Lane layout, as the Pallas wrapper's: x (C, L) is cut into nchunks chunks
per stream, and stream c's chunk i lands on lane c*nchunks + i. Each lane
re-derives its entry state from the ``warmup`` samples before its chunk,
starting from its stream's carried state; warmup steps before the
stream's first sample are skipped (the per-lane t_start). Inputs and
outputs are time-major (steps, lanes) f32/i32 planes. A stream whose last
chunk was zero-padded gets its carried state re-derived exactly from the
unpadded tail, and a block with L <= chunk + warmup runs exactly; both
are launches of the same kernel with an empty warmup (``front_exact``).

Dispatch: CPU tensors take the plain versions (``front_chunked_ref``,
``kernels/am_backend.front_exact``); CUDA tensors launch the kernel or
raise. There is no fallback from one to the other.

Unlike the Pallas wrapper there is no VMEM-bound warmup cap and no
padding of the lanes to 128.
"""

from __future__ import annotations

import torch

from ..kernels import am_backend as kab
from ..kernels import lanes
from ..kernels.agc import AgcState
from ..kernels.am_backend import AmBackendParams, AmBackendState, FrontState
from ..kernels.pll import PllState
from . import launch
from .first_order import linear_tail

KERNEL = "am_front_scan"


def _scalars(p: AmBackendParams):
    """The 9 f32 scalars the kernel reads, stacked on the device."""
    a = p.agc
    return torch.stack([
        a.alpha, a.locked.float(), a.squelch.float(), a.threshold,
        a.timeout.float(), a.scale, p.pll_alpha, p.pll_beta, p.use_pll,
    ])


def _launch(p: AmBackendParams, st: FrontState, xre, xim, nchunks: int,
            warmup: int):
    """Launch am_front_scan on (chunk, lanes) f32 planes xre/xim (lane
    c*nchunks + i), from per-stream state leaves of shape (C,). Returns
    (vr (chunk, lanes) f32, modes (chunk, lanes) i32, FrontState of
    per-lane final states)."""
    dev = xre.device
    launch.on_cuda(KERNEL, dev)
    chunk, lanes_ = xre.shape
    if lanes_ % nchunks:
        raise ValueError(f"{KERNEL}: {lanes_} lanes is not a whole "
                         f"number of streams of {nchunks} chunks")
    C = lanes_ // nchunks
    f32, i32 = torch.float32, torch.int32
    launch.check(KERNEL, "xre", xre, f32, (chunk, lanes_), dev)
    launch.check(KERNEL, "xim", xim, f32, (chunk, lanes_), dev)
    init = [st.agc.g, st.agc.y2p, st.agc.sq_mode, st.agc.sq_timer,
            st.pll.theta, st.pll.freq]
    dtypes = [f32, f32, i32, i32, f32, f32]
    for t, dt, name in zip(init, dtypes, ("g", "y2p", "sq_mode", "sq_timer",
                                          "theta", "freq")):
        launch.check(KERNEL, name, t, dt, (C,), dev)
    scal = _scalars(p)
    launch.check(KERNEL, "scalars", scal, f32, (9,), dev)
    vr = torch.empty((chunk, lanes_), dtype=f32, device=dev)
    modes = torch.empty((chunk, lanes_), dtype=i32, device=dev)
    fin = [torch.empty((lanes_,), dtype=dt, device=dev) for dt in dtypes]
    launch.launch(KERNEL, dev, scal, xre, xim, *init, vr, modes, *fin,
                  lanes_, nchunks, chunk, warmup)
    _launch.launches += 1
    _launch.steps += chunk + warmup
    return vr, modes, FrontState(AgcState(*fin[:4]), PllState(*fin[4:]))


_launch.launches = 0
_launch.steps = 0       # dependent steps a lane, summed over the launches


def front_exact(p: AmBackendParams, st: FrontState, x):
    """Exact sequential front over x (C, L) complex64, state leaves (C,).
    On CUDA: one launch of the kernel with one lane per stream and an
    empty warmup. On the CPU: kernels/am_backend.front_exact."""
    if x.device.type == "cpu":
        return kab.front_exact(p, st, x)
    C, L = x.shape
    xre, xim, _, _ = lanes.planes(x, L)
    vr, modes, fin = _launch(p, st, xre, xim, 1, 0)
    return fin, (vr.T, modes.T)


def front_chunked(p: AmBackendParams, st: FrontState, x, chunk: int,
                  warmup: int):
    """Batched chunk-parallel AGC+PLL front. x: (C, L) complex64, state
    leaves (C,). Returns (FrontState (C,), (vr (C, L) f32, modes (C, L)
    i32)). The CUDA kernel on a CUDA tensor, ``front_chunked_ref`` on a CPU
    one."""
    if x.device.type == "cpu":
        return front_chunked_ref(p, st, x, chunk, warmup)
    C, L = x.shape
    if L <= chunk + warmup:
        return front_exact(p, st, x)
    xre, xim, nchunks, pad = lanes.planes(x, chunk)
    vr, modes, fin = _launch(p, st, xre, xim, nchunks, warmup)
    front = lanes.per_stream(fin, C, -1)
    if pad:
        # the last chunk of every stream was zero-padded: re-derive each
        # stream's carried state exactly from its unpadded tail, starting
        # from the state the previous chunk ended in
        front, _ = front_exact(p, lanes.per_stream(fin, C, -2),
                               x[:, (nchunks - 1) * chunk:])
    return front, (lanes.unplanes(vr, C, L), lanes.unplanes(modes, C, L))


def front_chunked_ref(p: AmBackendParams, st: FrontState, x, chunk: int,
                      warmup: int):
    """The plain PyTorch version of ``front_chunked``: the same lanes, the
    same warmup windows (materialised here, with a per-lane validity start)
    and the same tail fix, as a Python loop over the steps of
    kernels/am_backend.front_sample_step on lane vectors
    (kernels/lanes.chunked_scan). Runs on any device; it launches no
    kernel."""
    C, L = x.shape
    if L <= chunk + warmup:
        return kab.front_exact(p, st, x)
    _, final, (vr, modes), nchunks, pad = lanes.chunked_scan(
        lambda s, xr, xi: kab.front_sample_step(p, s, xr, xi), st, x, chunk,
        warmup)
    front = lanes.per_stream(final, C, -1)
    if pad:
        front, _ = kab.front_exact(p, lanes.per_stream(final, C, -2),
                                   x[:, (nchunks - 1) * chunk:])
    return front, (lanes.unplanes(vr, C, L), lanes.unplanes(modes, C, L))


def am_backend_chunked(p: AmBackendParams, state: AmBackendState, x,
                       chunk: int, *, warmup: int):
    """Fused back end over a 1-D complex block x (N,): the feedback core as
    a one-stream ``front_chunked`` (the kernel on CUDA), then the DC
    tracker and de-emphasis as blocked scans (``cuda/first_order.
    linear_tail``: one launch of csrc/first_order_scan.cu on CUDA). A
    block with N <= chunk + warmup runs the front exactly (one kernel lane
    on CUDA) and the same linear tail, where the JAX
    package runs its serial am_backend_exact. Returns (state, (pcm,
    modes))."""
    st1 = lanes.one_stream(FrontState(state.agc, state.pll))
    front, (vr, modes) = front_chunked(p, st1, x[None], chunk, warmup)
    front = lanes.first_stream(front)
    (dc_last, de_last), pcm = linear_tail(p, state.dc, state.deemph, vr[0])
    new_state = AmBackendState(agc=front.agc, pll=front.pll,
                               dc=dc_last, deemph=de_last)
    return new_state, (pcm, modes[0])
