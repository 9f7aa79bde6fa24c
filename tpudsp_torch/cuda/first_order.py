"""The blocked first-order recurrence on the card: the CUDA kernel
``csrc/first_order_scan.cu``.

The JAX package runs ``tpudsp/kernels/iir.py`` ``first_order_apply_blocked``
as an einsum and a lax.scan over the blocks (no Pallas kernel); the port
runs it as one hand-written kernel launch per call:

- ``first_order_apply_blocked``: one recurrence over x (n,) with a 0-d
  y_prev, or over C rows (C, n) with y_prev (C,), in one launch;
- ``linear_tail``: the AM receiver's DC tracker, audio line and
  de-emphasis over vr (n,), in one launch.

Dispatch: CPU tensors take the plain versions in ``kernels/iir``; CUDA
tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import torch

from ..kernels import iir as kiir
from . import launch

KERNEL = "first_order_scan"


def _launch(entry: str, tabs, scal, x, carries):
    """Launch ``entry`` of csrc/first_order_scan.cu over the rows of x
    (C, n) f32 with the tables ``tabs``, the scalars ``scal`` (None for
    first_order_scan) and the per-row carries (C,). Returns (y (C, n), the
    last value of each recurrence per row)."""
    dev = x.device
    launch.on_cuda(KERNEL, dev)
    C, n = x.shape
    if n == 0:
        raise ValueError(f"{KERNEL}: a row needs at least one sample")
    f32 = torch.float32
    launch.check(KERNEL, "x", x, f32, (C, n), dev)
    for t in tabs:
        launch.check(KERNEL, "table", t, f32, (kiir.L_BLOCK * (kiir.L_BLOCK + 1) + 2,), dev)
    for t in carries:
        launch.check(KERNEL, "carry", t, f32, (C,), dev)
    head = list(tabs)
    if scal is not None:
        launch.check(KERNEL, "scalars", scal, f32, (2,), dev)
        head.append(scal)
    y = torch.empty((C, n), dtype=f32, device=dev)
    last = [torch.empty((C,), dtype=f32, device=dev) for _ in carries]
    launch.launch(entry, dev, *head, x, *carries, y, *last, C, n, source=KERNEL)
    _launch.launches += 1
    return y, last


_launch.launches = 0


def first_order_apply_blocked(b0: float, a: float, y_prev, x):
    """y[n] = b0 x[n] + a y[n-1] as kernels/iir.first_order_apply_blocked
    computes it, over x (n,) with a 0-d y_prev or over rows (C, n) with
    y_prev (C,). Returns (y_last, y) shaped like y_prev and x."""
    if x.device.type == "cpu":
        return kiir.first_order_apply_blocked(b0, a, y_prev, x)
    n = x.shape[-1]
    rows = x.reshape(-1, n).contiguous()
    y_prev = torch.as_tensor(y_prev, dtype=torch.float32, device=x.device)
    tab = kiir.device_table(float(b0), float(a), x.device)
    y, (last,) = _launch("first_order_scan", (tab,), None, rows,
                         (y_prev.reshape(rows.shape[0]).contiguous(),))
    return last.reshape(x.shape[:-1]), y.reshape(x.shape)


def linear_tail(p, dc0, de0, vr):
    """The AM receiver's linear tail over vr (n,) f32, as kernels/iir.
    linear_tail computes it: on CUDA, one launch for both recurrences and
    the audio line between them. Returns ((dc_last, de_last), pcm)."""
    if vr.device.type == "cpu":
        return kiir.linear_tail(p, dc0, de0, vr)
    dev = vr.device
    tabs = (kiir.device_table(1.0 - p.dc_rho, p.dc_rho, dev),
            kiir.device_table(p.deemph_b0, p.deemph_a, dev))
    scal = torch.stack([p.use_dc, p.inv_mod]).float()
    pcm, (dc_last, de_last) = _launch(
        "linear_tail_scan", tabs, scal, vr.reshape(1, -1).contiguous(),
        (dc0.reshape(1).float(), de0.reshape(1).float()))
    return (dc_last[0], de_last[0]), pcm[0]
