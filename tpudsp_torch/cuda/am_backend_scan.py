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

``front_chunked_mc`` runs the same front over streams held as the columns
of a (L, C) matrix (the channelizer's Y), read in place by the kernel's
matrix instance with the lanes channel-minor (lane i*C + c), and writes vr
and modes as (C, L) rows: no planes, no copies. Its outputs and states are
``front_chunked``'s of the transpose, bit for bit.

Dispatch: CPU tensors take the plain versions (``front_chunked_ref``,
``front_chunked_mc_ref``, ``kernels/am_backend.front_exact``); CUDA
tensors launch the kernel or raise. There is no fallback from one to the
other.

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


_STATE = (("g", torch.float32), ("y2p", torch.float32), ("sq_mode", torch.int32),
          ("sq_timer", torch.int32), ("theta", torch.float32), ("freq", torch.float32))


def _state_args(st: FrontState, C: int, lanes_: int, dev):
    """The per-stream state leaves (C,), checked, and the final state's
    per-lane leaves (lanes_,), allocated."""
    init = [st.agc.g, st.agc.y2p, st.agc.sq_mode, st.agc.sq_timer,
            st.pll.theta, st.pll.freq]
    for t, (name, dt) in zip(init, _STATE):
        launch.check(KERNEL, name, t, dt, (C,), dev)
    fin = [torch.empty((lanes_,), dtype=dt, device=dev) for _, dt in _STATE]
    return init, fin


def _count(chunk: int, warmup: int):
    _launch.launches += 1
    _launch.steps += chunk + warmup


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
    init, fin = _state_args(st, C, lanes_, dev)
    scal = _scalars(p)
    launch.check(KERNEL, "scalars", scal, f32, (9,), dev)
    vr = torch.empty((chunk, lanes_), dtype=f32, device=dev)
    modes = torch.empty((chunk, lanes_), dtype=i32, device=dev)
    launch.launch(KERNEL, dev, scal, xre, xim, *init, vr, modes, *fin,
                  lanes_, nchunks, chunk, warmup)
    _count(chunk, warmup)
    return vr, modes, FrontState(AgcState(*fin[:4]), PllState(*fin[4:]))


_launch.launches = 0
_launch.steps = 0       # dependent steps a lane, summed over the launches
_launch.matrix = 0      # of the launches, those of the matrix instance


def _launch_mc(scal, st: FrontState, Y, chunk: int, warmup: int, outputs: bool = True):
    """Launch the kernel's matrix instance over the columns of Y (L, C)
    complex64, read in place (lane i*C + c of nchunks = ceil(L / chunk)
    chunks a stream), from per-stream state leaves (C,), with the kernel's
    9 scalars ``scal``. Returns (vr (C, L) f32, modes (C, L) i32, FrontState
    of per-lane final states (nchunks*C,)); vr and modes are None, and not
    written, unless ``outputs``."""
    dev = Y.device
    launch.on_cuda(KERNEL, dev)
    L, C = Y.shape
    nchunks = -(-L // chunk)
    launch.check(KERNEL, "Y", Y, torch.complex64, (L, C), dev)
    launch.check(KERNEL, "scalars", scal, torch.float32, (9,), dev)
    init, fin = _state_args(st, C, nchunks * C, dev)
    vr = modes = None
    if outputs:
        vr = torch.empty((C, L), dtype=torch.float32, device=dev)
        modes = torch.empty((C, L), dtype=torch.int32, device=dev)
    launch.launch("am_front_scan_mc", dev, scal, Y, *init, vr, modes, *fin,
                  C, nchunks, chunk, warmup, L, source=KERNEL)
    _count(chunk, warmup)
    _launch.matrix += 1
    return vr, modes, FrontState(AgcState(*fin[:4]), PllState(*fin[4:]))


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


def front_chunked_mc(p: AmBackendParams, st: FrontState, Y, chunk: int,
                     warmup: int):
    """``front_chunked`` over the C streams held as the columns of Y (L, C)
    complex64 (the channelizer's channel matrix), state leaves (C,). Returns
    what ``front_chunked(p, st, Y.T, chunk, warmup)`` returns, bit for bit:
    (FrontState (C,), (vr (C, L) f32, modes (C, L) i32)). On a CUDA tensor
    the kernel's matrix instance reads Y in place and writes the rows; a
    padded last chunk's exact re-run is a second launch of it over Y's last
    rows, and the carried state is a view of the launches' per-lane states.
    ``front_chunked_mc_ref`` on a CPU tensor."""
    if Y.device.type == "cpu":
        return front_chunked_mc_ref(p, st, Y, chunk, warmup)
    return _front_mc(p, st, Y, chunk, warmup)


def _front_mc(p: AmBackendParams, st: FrontState, Y, chunk: int, warmup: int):
    """``front_chunked_mc``'s launches."""
    L, C = Y.shape
    scal = _scalars(p)
    if L <= chunk + warmup:
        vr, modes, front = _launch_mc(scal, st, Y, L, 0)
        return front, (vr, modes)
    vr, modes, fin = _launch_mc(scal, st, Y, chunk, warmup)
    nchunks = -(-L // chunk)
    front = lanes.per_stream_mc(fin, C, -1)
    if nchunks * chunk > L:
        # the last chunk was zero-padded: re-derive each stream's carried
        # state exactly from its unpadded tail (Y's last rows, contiguous),
        # starting from the state the previous chunk ended in
        base = (nchunks - 1) * chunk
        _, _, front = _launch_mc(scal, lanes.per_stream_mc(fin, C, -2), Y[base:], L - base, 0,
                                 outputs=False)
    return front, (vr, modes)


def front_chunked_mc_ref(p: AmBackendParams, st: FrontState, Y, chunk: int,
                         warmup: int):
    """The plain PyTorch version of ``front_chunked_mc``: the matrix
    instance's channel-minor lanes, their warmup windows and padding read
    from Y's columns (kernels/lanes.chunked_scan_mc), and the same tail fix.
    Runs on any device; it launches no kernel."""
    L, C = Y.shape
    if L <= chunk + warmup:
        return kab.front_exact(p, st, Y.T)
    _, final, (vr, modes), nchunks, pad = lanes.chunked_scan_mc(
        lambda s, xr, xi: kab.front_sample_step(p, s, xr, xi), st, Y, chunk,
        warmup)
    front = lanes.per_stream_mc(final, C, -1)
    if pad:
        front, _ = kab.front_exact(p, lanes.per_stream_mc(final, C, -2),
                                   Y[(nchunks - 1) * chunk:].T)
    return front, (lanes.unplanes_mc(vr, C, L), lanes.unplanes_mc(modes, C, L))


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
