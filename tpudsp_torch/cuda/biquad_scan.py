"""The compensated SOS cascade on the card: the CUDA kernel
``csrc/biquad_scan.cu``.

The JAX package runs ``tpudsp/kernels/iir.py`` ``sos_apply_df`` as a
log-depth lax.associative_scan of double-float 2x2 maps per section (no
Pallas kernel); the port runs the whole cascade of a call as one
hand-written kernel launch. x is (N,) f32, or complex64 run as its re and
im rows in place; the state is (S, 2) of the same type.

Dispatch: CPU tensors take the plain version ``kernels/iir.sos_apply_df``;
CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import torch

from ..kernels import iir as kiir
from . import launch

KERNEL = "biquad_scan"


def sos_apply_df(tab, state, x):
    """The SOS cascade of ``tab`` (kernels/iir.sos_table's (S, SOS_WIDTH)
    f32 table, on x's device) over x from ``state``, as kernels/iir.
    sos_apply_df computes it. Returns (new_state, y)."""
    if x.device.type == "cpu":
        return kiir.sos_apply_df(tab, state, x)
    dev = x.device
    launch.on_cuda(KERNEL, dev)
    n = x.shape[-1]
    S = tab.shape[0]
    if n == 0:
        return state, x
    cplx = x.is_complex()
    dt = torch.complex64 if cplx else torch.float32
    launch.check(KERNEL, "x", x, dt, (n,), dev)
    launch.check(KERNEL, "table", tab, torch.float32, (S, kiir.SOS_WIDTH), dev)
    launch.check(KERNEL, "state", state, dt, (S, 2), dev)
    if tab.data_ptr() % 16:
        raise ValueError(f"{KERNEL}: table must start on a 16-byte boundary")
    rows, rs, cs = (2, 1, 2) if cplx else (1, n, 1)
    y = torch.empty_like(x)
    last = torch.empty_like(state)
    tiles = -(-n // kiir.SOS_TILE)
    windows = -(-tiles // kiir.SOS_WINDOW)
    stream = launch.stream(dev)
    # a link per section, row and tile (its aggregate) and window (its entry)
    scratch, base, epoch = launch.chain(dev, stream, S * rows * (tiles + windows), rows * tiles)
    launch.launch(KERNEL, dev, tab, x, state, y, last, scratch, S, rows, n, rs, cs, base,
                  epoch, on=stream)
    sos_apply_df.launches += 1
    return last, y


sos_apply_df.launches = 0
