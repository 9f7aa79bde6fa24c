"""The blocked first-order recurrence on the card: the CUDA kernel
``csrc/first_order_scan.cu``.

The JAX package runs ``tpudsp/kernels/iir.py`` ``first_order_apply_blocked``
as an einsum and a lax.scan over the blocks (no Pallas kernel); the port
runs it as one hand-written kernel launch per call:

- ``first_order_apply_blocked``: one recurrence over x (n,) with a 0-d
  y_prev, or over C rows (C, n) with y_prev (C,), in one launch;
- ``first_order_apply_blocked_c64``: one recurrence over x (n,)
  complex64 (its re and im parts as two rows, read in place) with a
  complex64 y_prev, in one launch of the same entry (its launches counted
  apart);
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


def _launch(entry: str, tabs, scal, x, carries, counter=None):
    """Launch ``entry`` of csrc/first_order_scan.cu with the tables ``tabs``
    and the scalars ``scal`` (None for first_order_scan) over the rows of
    x: (C, n) f32 with per-row carries (C,), or, for first_order_scan,
    (n,) complex64 read in place as its re and im rows with complex64 0-d
    carries. Counts the launch in ``counter``'s (default ``_launch``)
    ``launches``. Returns (y like x, the last value of each recurrence like
    its carry)."""
    dev = x.device
    launch.on_cuda(KERNEL, dev)
    n = x.shape[-1]
    if n == 0:
        raise ValueError(f"{KERNEL}: a row needs at least one sample")
    cplx = x.is_complex()
    dt = torch.complex64 if cplx else torch.float32
    # rows of the kernel, rows of x's own type, and the strides of a row
    C, R, rs, cs = (2, 1, 1, 2) if cplx else (x.shape[0], x.shape[0], n, 1)
    launch.check(KERNEL, "x", x, dt, (n,) if cplx else (C, n), dev)
    for t in tabs:
        launch.check(KERNEL, "table", t, torch.float32, (kiir.TABLE_SIZE,), dev)
    for t in carries:
        launch.check(KERNEL, "carry", t, dt, () if cplx else (C,), dev)
    head = list(tabs)
    if scal is not None:
        launch.check(KERNEL, "scalars", scal, torch.float32, (2,), dev)
        head.append(scal)
    # y and the last values in one allocation
    out = torch.empty(R * (n + len(carries)), dtype=dt, device=dev)
    y = out[:R * n].view(x.shape)
    last = [out[R * (n + k):R * (n + k + 1)].view(carries[k].shape)
            for k in range(len(carries))]
    geometry = (C, n) if scal is not None else (C, n, rs, cs)
    tiles = -(-n // (kiir.TILE_BLOCKS * kiir.L_BLOCK))
    stream = launch.stream(dev)
    scratch, base, epoch = launch.chain(dev, stream, len(carries) * C * tiles, C * tiles)
    launch.launch(entry, dev, *head, x, *carries, y, *last, scratch, *geometry, base, epoch,
                  source=KERNEL, on=stream)
    (counter or _launch).launches += 1
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


def first_order_apply_blocked_c64(b0: float, a: float, y_prev, x):
    """y[n] = b0 x[n] + a y[n-1] over x (n,) complex64 with a complex64
    y_prev, as kernels/iir.first_order_apply_blocked_c64 computes it: one
    launch, the re and im parts as two rows. Returns (y_last, y)."""
    if x.device.type == "cpu":
        return kiir.first_order_apply_blocked_c64(b0, a, y_prev, x)
    y_prev = torch.as_tensor(y_prev, dtype=torch.complex64, device=x.device).reshape(())
    tab = kiir.device_table(float(b0), float(a), x.device)
    y, (last,) = _launch("first_order_scan", (tab,), None, x, (y_prev.contiguous(),),
                         counter=first_order_apply_blocked_c64)
    return last, y


first_order_apply_blocked_c64.launches = 0


def linear_tail(p, dc0, de0, vr):
    """The AM receiver's linear tail over vr (n,) f32, as kernels/iir.
    linear_tail computes it: on CUDA, one launch for both recurrences and
    the audio line between them. Returns ((dc_last, de_last), pcm)."""
    if vr.device.type == "cpu":
        return kiir.linear_tail(p, dc0, de0, vr)
    dev = vr.device
    tabs = (kiir.device_table(1.0 - p.dc_rho, p.dc_rho, dev),
            kiir.device_table(p.deemph_b0, p.deemph_a, dev))
    # [use_dc, inv_mod], made once per parameter set
    scal = launch.memo("linear_tail", (p.use_dc, p.inv_mod),
                       lambda: torch.stack([p.use_dc, p.inv_mod]).float())
    pcm, (dc_last, de_last) = _launch(
        "linear_tail_scan", tabs, scal, vr.reshape(1, -1).contiguous(),
        (dc0.reshape(1).float(), de0.reshape(1).float()))
    return (dc_last[0], de_last[0]), pcm[0]
