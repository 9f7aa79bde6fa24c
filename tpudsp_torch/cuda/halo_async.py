"""The async-halo front end on the card: the ring halo exchange overlapped
with the strided complex decimating FIR of the CUDA kernel
``csrc/halo_async.cu`` (port of the Pallas kernel
``tpudsp/pallas/halo_async.py``).

``bank_front_async`` is the drop-in for a time-sharded front end's
exchange-then-filter: each rank's output y (C, nj) filters
X = [halo | iq_loc], where the halo is the left neighbour's last
``taps - 1`` samples (the block-carried tail on rank 0). On CUDA tensors
the wrapper

1. posts the halo exchange on the mesh's time group
   (``parallel/halo.post``: NCCL on the card, at wire width);
2. launches the kernel over the interior outputs [S, nj), which read only
   this rank's samples, on the current stream while the exchange is in
   flight;
3. waits on the exchange, which orders the current stream after it;
4. launches the kernel over the boundary outputs [0, S) with the received
   halo.

``cfir`` is the single-card entry the receiver bank's front end takes
(``chains/bank.bank_step``): one launch over all outputs, with the
block-carried tail as the halo and no exchange.

This is how a TPU kernel's in-kernel remote copy translates to Hopper:
the collective runs outside the kernel. On the TPU the last shard routes
the block-carried tail round the ring to shard 0; here every rank holds
the carried state, so rank 0 reads it directly.

Dispatch: CPU tensors take the plain version (``bank_front_async_ref``:
the same exchange, blocking, then ``cfir_ref``; ``cfir_ref`` for
``cfir``); CUDA tensors launch the kernel or raise. There is no fallback
from one to the other.
"""

from __future__ import annotations

import torch

from ..kernels import decimate as kdec
from . import launch

KERNEL = "halo_async"
# wire format of a (n,) complex64 or (n, 2) int16 / uint8 sample array:
# the kernel's format code, the centring offset and the pad value
_FORMATS = {torch.complex64: (0, 0.0, 0), torch.int16: (1, 0.0, 0),
            torch.uint8: (2, 127.5, 127)}
REF_TILE = 2048   # outputs per matmul of the plain version (bounds its memory)


def _format(x):
    wire = x.ndim == 2
    if x.dtype not in _FORMATS or wire != (x.dtype != torch.complex64) \
            or (wire and x.shape[1] != 2):
        raise ValueError(f"{KERNEL}: samples must be (n,) complex64 or (n, 2) "
                         f"int16 / uint8, got {x.dtype} {tuple(x.shape)}")
    return _FORMATS[x.dtype]


def boundary(halo_len: int, D1: int, nj: int) -> int:
    """S, the number of boundary outputs: the first S outputs read the
    halo, the rest only the rank's own samples."""
    return min(-(-halo_len // D1), nj)


def _pack(Tre, Tim):
    """(C, Kc, D1) blocked taps -> the kernel's (win, C) taps: complex64,
    or float32 when ``Tim`` is None (real taps)."""
    C = Tre.shape[0]
    if Tim is None:
        return Tre.reshape(C, -1).float().T.contiguous()
    return torch.complex(Tre.reshape(C, -1).float(),
                         Tim.reshape(C, -1).float()).T.contiguous()


def pack_taps(Tre, Tim):
    """``_pack``, made once per taps tensor (a receiver passes the same
    taps every block) rather than a device transpose-copy every call."""
    return launch.memo("pack_taps", (Tre, Tim), lambda: _pack(Tre, Tim))


def _launch(x, halo, taps, y, D1: int, j_begin: int, j_end: int):
    """Launch halo_async over outputs [j_begin, j_end) of y (C, nj)."""
    dev = x.device
    launch.on_cuda(KERNEL, dev)
    fmt, _, _ = _format(x)
    win, C = taps.shape
    nj = y.shape[1]
    if taps.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"{KERNEL}: taps must be float32 or complex64, got {taps.dtype}")
    launch.check(KERNEL, "x", x, x.dtype, x.shape, dev)
    launch.check(KERNEL, "halo", halo, x.dtype, (halo.shape[0],) + x.shape[1:], dev)
    launch.check(KERNEL, "taps", taps, taps.dtype, (win, C), dev)
    launch.check(KERNEL, "y", y, torch.complex64, (C, nj), dev)
    if win % D1 or not 0 <= j_begin <= j_end <= nj:
        raise ValueError(f"{KERNEL}: window {win} is not whole frames of "
                         f"{D1}, or outputs [{j_begin}, {j_end}) not in [0, {nj})")
    launch.launch(KERNEL, dev, x, halo, taps, y, fmt, int(taps.dtype == torch.float32),
                  x.shape[0], halo.shape[0], C, win, D1, nj, j_begin, j_end)
    _launch.launches += 1


_launch.launches = 0


def _ring(axis_name):
    """The sharded runtime's halo exchange and the ring's axis, imported
    here so that the single-card entry ``cfir`` (the receiver bank's)
    leaves ``tpudsp_torch.parallel`` unloaded."""
    from ..parallel import halo as phalo
    from ..parallel.mesh import TIME_AXIS
    return phalo, TIME_AXIS if axis_name is None else axis_name


def bank_front_async(iq_loc, tail, Tre, Tim, D1: int, nj: int, mesh,
                     axis_name: str | None = None):
    """iq_loc: (n_loc,) complex64, or a raw (n_loc, 2) int16 / uint8 wire
    slice (Tre/Tim then carry the wire scale; uint8 is centred by 127.5 on
    load); tail: the matching (halo_len,) / (halo_len, 2) block-carried
    fill for rank 0; Tre/Tim: (C, Kc, D1) blocked correlation-order taps,
    ``Tim`` None for real taps (the kernel then skips the zero products);
    mesh: the (channel, time) mesh; axis_name: the ring's axis (None: the
    mesh's time axis). Returns y (C, nj) complex64, as the JAX wrapper. Where JAX takes the axis size, the mesh gives it; the Pallas
    tile has no counterpart (``boundary`` sets the split). The kernel on
    CUDA tensors, ``bank_front_async_ref`` on CPU ones."""
    if iq_loc.device.type == "cpu":
        return bank_front_async_ref(iq_loc, tail, Tre, Tim, D1, nj, mesh,
                                    axis_name)
    phalo, axis_name = _ring(axis_name)
    C, Kc, D1_ = Tre.shape
    if D1_ != D1:
        raise ValueError(f"{KERNEL}: taps blocked by {D1_}, not D1 = {D1}")
    halo_len = tail.shape[0]
    S = boundary(halo_len, D1, nj)
    taps = pack_taps(Tre, Tim)
    iq_loc = iq_loc.contiguous()
    y = torch.empty((C, nj), dtype=torch.complex64, device=iq_loc.device)
    pending = phalo.post(iq_loc[iq_loc.shape[0] - halo_len:], mesh, axis_name)
    if S < nj:
        _launch(iq_loc, tail, taps, y, D1, S, nj)  # interior, halo not read
    halo = phalo.wait(pending, tail).contiguous()
    _launch(iq_loc, halo, taps, y, D1, 0, S)
    return y


def cfir(x, halo, Tre, Tim, D1: int, nj: int):
    """y (C, nj) of X = [halo | x | pad] on one card: one launch over
    outputs [0, nj), the halo read in place. x: (n,) complex64 or a raw (n,
    2) int16 / uint8 block (uint8 centred by 127.5 on load); halo: the
    matching block-carried tail; Tre/Tim: (C, Kc, D1) blocked
    correlation-order taps (``Tim`` None for real taps), packed once per
    taps tensor. The kernel on CUDA tensors, ``cfir_ref`` on CPU ones."""
    if x.device.type == "cpu":
        return cfir_ref(x, halo, Tre, Tim, D1, nj)
    C, _, D1_ = Tre.shape
    if D1_ != D1:
        raise ValueError(f"{KERNEL}: taps blocked by {D1_}, not D1 = {D1}")
    y = torch.empty((C, nj), dtype=torch.complex64, device=x.device)
    _launch(x.contiguous(), halo.contiguous(), pack_taps(Tre, Tim), y, D1, 0, nj)
    return y


def cfir_ref(x, halo, Tre, Tim, D1: int, nj: int):
    """The plain version of the kernel over all nj outputs: X = [halo | x |
    pad] centred as the kernel loads it (uint8 minus 127.5, pad 127), then
    ``kernels/decimate.strided_cfir_matmul_wide`` (full f32; ``Tim`` None
    as zeros) over tiles of REF_TILE outputs. Returns (C, nj) complex64."""
    _, off, pad_value = _format(x)
    C, Kc, _ = Tre.shape
    win = Kc * D1
    if Tim is None:
        Tim = torch.zeros_like(Tre)
    X = torch.cat([halo, x])
    pad = max(0, (nj - 1) * D1 + win - X.shape[0])
    if pad:
        X = torch.cat([X, torch.full((pad,) + X.shape[1:], pad_value,
                                     dtype=X.dtype, device=X.device)])
    if X.is_complex():
        Xc = X
    else:
        Xf = X.float() - off
        Xc = torch.complex(Xf[:, 0], Xf[:, 1])
    y = torch.empty((C, nj), dtype=torch.complex64, device=x.device)
    for j0 in range(0, nj, REF_TILE):
        nt = min(REF_TILE, nj - j0)
        y[:, j0:j0 + nt] = kdec.strided_cfir_matmul_wide(
            Xc[j0 * D1:(j0 + nt - 1) * D1 + win], Tre, Tim, D1, nt)
    return y


def bank_front_async_ref(iq_loc, tail, Tre, Tim, D1: int, nj: int, mesh,
                         axis_name: str | None = None):
    """The plain PyTorch version of ``bank_front_async``: the same
    exchange, waited on at once, then ``cfir_ref``. Runs on any device; it
    launches no kernel."""
    phalo, axis_name = _ring(axis_name)
    halo = phalo.left_halo_rows(iq_loc, tail.shape[0], mesh, tail, axis_name)
    return cfir_ref(iq_loc, halo, Tre, Tim, D1, nj)
