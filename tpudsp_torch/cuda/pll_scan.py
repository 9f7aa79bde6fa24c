"""The carrier-PLL scan on the card: the CUDA kernel ``csrc/pll_scan.cu``.

The JAX package runs ``tpudsp/kernels/pll.py`` ``pll_carrier_scan`` as a
lax.scan (no Pallas kernel); the port runs it as one hand-written kernel
launch, never a Python loop of per-sample launches. Both functions take a
batch x (C, L) complex64 with per-stream PllState leaves (C,) and return
(PllState (C,), thetas (C, L) f32), theta before each update.

- ``pll_carrier_scan``: one lane per stream, empty warmup (exact).
- ``pll_carrier_scan_chunked``: lanes as in ``kernels/lanes``, chunk and
  warmup from ``kernels/pll.chunk_plan`` (pll.py's defaults); a padded
  last chunk re-runs from the last chunk's warmup-derived entry state,
  which on the card is one exact launch over that chunk's warmup window
  and its tail. Blocks with L <= chunk + warmup run exactly.

Dispatch: CPU tensors take the plain versions in ``kernels/pll``; CUDA
tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import torch

from ..kernels import lanes
from ..kernels import pll as kpll
from ..kernels.pll import PllState
from . import launch

KERNEL = "pll_scan"


def _launch(st: PllState, xre, xim, nchunks: int, warmup: int, bw: float):
    """Launch pll_scan on (chunk, lanes) f32 planes from per-stream state
    leaves (C,). Returns (theta plane, per-lane final PllState)."""
    dev = xre.device
    launch.on_cuda(KERNEL, dev)
    chunk, nl = xre.shape
    if nl % nchunks:
        raise ValueError(f"{KERNEL}: {nl} lanes is not a whole number of "
                         f"streams of {nchunks} chunks")
    C = nl // nchunks
    f32 = torch.float32
    launch.check(KERNEL, "xre", xre, f32, (chunk, nl), dev)
    launch.check(KERNEL, "xim", xim, f32, (chunk, nl), dev)
    for t, name in zip(st, PllState._fields):
        launch.check(KERNEL, name, t, f32, (C,), dev)
    scal = torch.tensor(kpll.gains(bw), dtype=f32, device=dev)
    theta = torch.empty((chunk, nl), dtype=f32, device=dev)
    fin = PllState(*(torch.empty((nl,), dtype=f32, device=dev) for _ in st))
    launch.launch(KERNEL, dev, scal, xre, xim, *st, theta, *fin,
                  nl, nchunks, chunk, warmup)
    _launch.launches += 1
    return theta, fin


_launch.launches = 0


def pll_carrier_scan(st: PllState, x, bw: float):
    """Exact carrier scan. On CUDA: one launch with one lane per stream.
    On the CPU: kernels/pll.pll_carrier_scan."""
    if x.device.type == "cpu":
        return kpll.pll_carrier_scan(st, x, bw)
    C, L = x.shape
    xre, xim, _, _ = lanes.planes(x, L)
    theta, fin = _launch(st, xre, xim, 1, 0, bw)
    return fin, lanes.unplanes(theta, C, L)


def pll_carrier_scan_chunked(st: PllState, x, bw: float,
                             chunk: int | None = None,
                             warmup: int | None = None):
    """Chunk-parallel carrier scan: the kernel on a CUDA tensor,
    kernels/pll.pll_carrier_scan_chunked on a CPU one."""
    if x.device.type == "cpu":
        return kpll.pll_carrier_scan_chunked(st, x, bw, chunk, warmup)
    chunk, warmup = kpll.chunk_plan(bw, chunk, warmup)
    C, L = x.shape
    if L <= chunk + warmup:
        return pll_carrier_scan(st, x, bw)
    xre, xim, nchunks, pad = lanes.planes(x, chunk)
    theta, fin = _launch(st, xre, xim, nchunks, warmup, bw)
    new_state = lanes.per_stream(fin, C, -1)
    if pad:
        last = (nchunks - 1) * chunk
        new_state, _ = pll_carrier_scan(st, x[:, max(last - warmup, 0):], bw)
    return new_state, lanes.unplanes(theta, C, L)
