"""The AGC + squelch scan on the card: the CUDA kernel ``csrc/agc_scan.cu``
(port of the Pallas kernel ``tpudsp/pallas/agc_scan.py``), and the three
routes of the AGC op that launch it.

All functions take a batch x (C, L) complex64 with per-stream state leaves
(C,) and return (AgcState (C,), (y (C, L) complex64, modes (C, L) i32)).
Lanes are laid out as in ``kernels/lanes``. The routes differ only in
their chunk and in how a padded last chunk re-derives each stream's
carried state, and each mirrors its JAX counterpart, because the chunked
AGC's result depends on both:

- ``agc_chunked_pallas``: ``pallas/agc_scan.py::agc_chunked_pallas``; the
  tail re-runs from the PREVIOUS chunk's final state.
- ``agc_chunked``: ``kernels/agc.py::agc_apply_chunked``; the tail re-runs
  from the LAST chunk's warmup-derived entry state, i.e. the carried state
  run over that chunk's warmup window and then the tail -- on the card one
  exact launch over both.
- ``agc_exact``: ``kernels/agc.py::agc_apply``, one lane per stream with an
  empty warmup. Blocks with L <= chunk + warmup take it on both chunked
  routes.

Dispatch: CPU tensors take the plain versions (``kernels/agc`` and
``agc_chunked_pallas_ref``); CUDA tensors launch the kernel or raise.
There is no fallback from one to the other. Unlike the Pallas wrapper
there is no padding of the lanes to 128.
"""

from __future__ import annotations

import torch

from ..kernels import agc as kagc
from ..kernels import lanes
from ..kernels.agc import AgcParams, AgcState
from . import launch

KERNEL = "agc_scan"


def _scalars(p: AgcParams):
    """The 6 f32 scalars the kernel reads, stacked on the device."""
    return torch.stack([p.alpha, p.locked.float(), p.squelch.float(),
                        p.threshold, p.timeout.float(), p.scale])


def _launch(p: AgcParams, st: AgcState, xre, xim, nchunks: int, warmup: int):
    """Launch agc_scan on (chunk, lanes) f32 planes xre/xim from per-stream
    state leaves (C,). Returns (yre, yim, modes) planes and the per-lane
    final AgcState."""
    dev = xre.device
    launch.on_cuda(KERNEL, dev)
    chunk, nl = xre.shape
    if nl % nchunks:
        raise ValueError(f"{KERNEL}: {nl} lanes is not a whole number of "
                         f"streams of {nchunks} chunks")
    C = nl // nchunks
    f32, i32 = torch.float32, torch.int32
    launch.check(KERNEL, "xre", xre, f32, (chunk, nl), dev)
    launch.check(KERNEL, "xim", xim, f32, (chunk, nl), dev)
    dtypes = (f32, f32, i32, i32)
    for t, dt, name in zip(st, dtypes, AgcState._fields):
        launch.check(KERNEL, name, t, dt, (C,), dev)
    scal = _scalars(p)
    launch.check(KERNEL, "scalars", scal, f32, (6,), dev)
    yre = torch.empty((chunk, nl), dtype=f32, device=dev)
    yim = torch.empty((chunk, nl), dtype=f32, device=dev)
    modes = torch.empty((chunk, nl), dtype=i32, device=dev)
    fin = AgcState(*(torch.empty((nl,), dtype=dt, device=dev) for dt in dtypes))
    launch.launch(KERNEL, dev, scal, xre, xim, *st, yre, yim, modes, *fin,
                  nl, nchunks, chunk, warmup)
    _launch.launches += 1
    return yre, yim, modes, fin


_launch.launches = 0


def _outputs(yre, yim, modes, C: int, L: int):
    return (torch.complex(lanes.unplanes(yre, C, L), lanes.unplanes(yim, C, L)),
            lanes.unplanes(modes, C, L))


def agc_exact(p: AgcParams, st: AgcState, x):
    """Exact sequential AGC. On CUDA: one launch with one lane per stream
    and an empty warmup. On the CPU: kernels/agc.agc_apply."""
    if x.device.type == "cpu":
        return kagc.agc_apply(p, st, x)
    C, L = x.shape
    xre, xim, _, _ = lanes.planes(x, L)
    yre, yim, modes, fin = _launch(p, st, xre, xim, 1, 0)
    return fin, _outputs(yre, yim, modes, C, L)


def _chunked(p: AgcParams, st: AgcState, x, chunk: int, warmup: int,
             tail: str):
    """The kernel over the lanes of x, with ``tail``'s fix of a padded last
    chunk (kernels/agc.agc_chunked_lanes states both)."""
    C, L = x.shape
    if L <= chunk + warmup:
        return agc_exact(p, st, x)
    xre, xim, nchunks, pad = lanes.planes(x, chunk)
    yre, yim, modes, fin = _launch(p, st, xre, xim, nchunks, warmup)
    new_state = lanes.per_stream(fin, C, -1)
    last = (nchunks - 1) * chunk
    if pad and tail == "prev":
        new_state, _ = agc_exact(p, lanes.per_stream(fin, C, -2), x[:, last:])
    elif pad:
        new_state, _ = agc_exact(p, st, x[:, max(last - warmup, 0):])
    return new_state, _outputs(yre, yim, modes, C, L)


def agc_chunked_pallas(p: AgcParams, st: AgcState, x, chunk: int = 1024,
                       warmup: int = 2048):
    """The Pallas route (``AGC(throughput_mode=True, use_pallas=True)``):
    the kernel on a CUDA tensor, ``agc_chunked_pallas_ref`` on a CPU one."""
    if x.device.type == "cpu":
        return agc_chunked_pallas_ref(p, st, x, chunk, warmup)
    return _chunked(p, st, x, chunk, warmup, "prev")


def agc_chunked_pallas_ref(p: AgcParams, st: AgcState, x, chunk: int = 1024,
                           warmup: int = 2048):
    """The plain PyTorch version of ``agc_chunked_pallas``: the same lanes,
    warmup windows and tail fix as a Python loop over the steps of
    kernels/agc.sample_step on lane vectors. Runs on any device; it
    launches no kernel."""
    return kagc.agc_apply_chunked(p, st, x, chunk, warmup, tail="prev")


def agc_chunked(p: AgcParams, st: AgcState, x, chunk: int, warmup: int):
    """The XLA route (``AGC(throughput_mode=True)`` otherwise): the kernel
    on a CUDA tensor, kernels/agc.agc_apply_chunked on a CPU one."""
    if x.device.type == "cpu":
        return kagc.agc_apply_chunked(p, st, x, chunk, warmup)
    return _chunked(p, st, x, chunk, warmup, "entry")
