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
        launch.check(KERNEL, "table", t, f32, (kiir.TABLE_SIZE,), dev)
    for t in carries:
        launch.check(KERNEL, "carry", t, f32, (C,), dev)
    head = list(tabs)
    if scal is not None:
        launch.check(KERNEL, "scalars", scal, f32, (2,), dev)
        head.append(scal)
    # y and the last values in one allocation
    out = torch.empty(C * (n + len(carries)), dtype=f32, device=dev)
    y = out[:C * n].view(C, n)
    last = [out[C * (n + k):C * (n + k + 1)] for k in range(len(carries))]
    tiles = -(-n // (kiir.TILE_BLOCKS * kiir.L_BLOCK))
    stream = launch.stream(dev)
    scratch, base, epoch = _chain(dev, stream, 4 + 4 * len(carries) * C * tiles, C * tiles)
    launch.launch(entry, dev, *head, x, *carries, y, *last, scratch, C, n, base, epoch,
                  source=KERNEL, on=stream)
    _launch.launches += 1
    return y, last


_launch.launches = 0
# per (device, stream): [scratch, blocks started on it, last epoch]. The
# kernel's blocks take their tiles by a counter in the scratch and pass
# their tiles' entries on through links in it, flagged with the launch's
# epoch: launches on one stream run in order, so they share the buffer
# without clearing it.
_chains: dict = {}
_EPOCHS = 2 ** 31 - 1


def _chain(dev, stream: int, size: int, blocks: int):
    """The stream's scratch of at least ``size`` int32 for a launch of
    ``blocks`` blocks, its block count before the launch (as a C int) and
    the launch's epoch."""
    st = _chains.get((dev, stream))
    if st is None or st[0].numel() < size:
        st = _chains[(dev, stream)] = [torch.zeros(max(size, 4096), dtype=torch.int32,
                                                   device=dev), 0, 0]
    if st[2] == _EPOCHS:   # every epoch used: clear the flags, start again
        st[0].zero_()
        st[1:] = [0, 0]
    st[2] += 1
    base = st[1]
    st[1] = (base + blocks) % 2 ** 32
    return st[0], base - 2 ** 32 if base >= 2 ** 31 else base, st[2]


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
    # [use_dc, inv_mod], made once per parameter set
    scal = launch.memo("linear_tail", (p.use_dc, p.inv_mod),
                       lambda: torch.stack([p.use_dc, p.inv_mod]).float())
    pcm, (dc_last, de_last) = _launch(
        "linear_tail_scan", tabs, scal, vr.reshape(1, -1).contiguous(),
        (dc0.reshape(1).float(), de0.reshape(1).float()))
    return (dc_last[0], de_last[0]), pcm[0]
