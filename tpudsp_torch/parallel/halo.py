"""Time-axis halo exchange (port of ``tpudsp/parallel/halo.py``).

Overlap-save filtering of a time-sharded stream: each rank needs the last
``halo`` samples of its left neighbour. Rank r sends its tail to rank r+1
with one ``torch.distributed.batch_isend_irecv`` on the time group; rank 0
takes the block-carried fill instead, which keeps streaming exact across
both rank and block boundaries. A one-rank time axis degenerates to the
fill. Tails travel as their raw bytes, so wire samples (int16 / uint8)
cross at wire width and every dtype goes over NCCL and gloo alike.

``post`` and ``wait`` split the exchange, so a caller can compute while it
is in flight (``cuda/halo_async.bank_front_async``); ``left_halo`` and
``left_halo_rows`` are the blocking forms of the JAX package's functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .mesh import TIME_AXIS, axis_size


class Pending(NamedTuple):
    """A posted exchange: the receive buffer (None on rank 0 and on a
    one-rank axis), the requests, and the tensors they read or write."""
    buf: torch.Tensor | None
    works: list
    tensors: tuple


def post(tail, mesh, axis: str = TIME_AXIS) -> Pending:
    """Post the exchange of ``tail``, this rank's last ``halo`` samples:
    send it to the right neighbour and receive the left neighbour's into a
    new buffer of the same shape and dtype. Returns at once."""
    T = axis_size(mesh, axis)
    if T == 1:
        return Pending(None, [], ())
    r = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    tail = tail.contiguous()
    ops = []
    if r + 1 < T:
        ops.append(dist.P2POp(dist.isend, tail.view(torch.uint8),
                              dist.get_global_rank(group, r + 1), group))
    buf = None
    if r > 0:
        buf = torch.empty_like(tail)
        ops.append(dist.P2POp(dist.irecv, buf.view(torch.uint8),
                              dist.get_global_rank(group, r - 1), group))
    return Pending(buf, dist.batch_isend_irecv(ops), (tail, buf))


def wait(pending: Pending, leftmost_fill):
    """Wait for a posted exchange; the left neighbour's samples, or
    ``leftmost_fill`` on rank 0. On the card the wait orders the current
    stream after the transfer."""
    for w in pending.works:
        w.wait()
    return leftmost_fill if pending.buf is None else pending.buf


def left_halo(x_local, halo: int, mesh, leftmost_fill, axis: str = TIME_AXIS):
    """The last ``halo`` samples of the left neighbour's (..., N_local)
    block, or ``leftmost_fill`` (..., halo) on rank 0. Time on the last
    axis."""
    if halo <= 0:
        return x_local[..., :0]
    return wait(post(x_local[..., -halo:], mesh, axis), leftmost_fill)


def left_halo_rows(x_local, halo: int, mesh, leftmost_fill,
                   axis: str = TIME_AXIS):
    """``left_halo`` with time on axis 0 of an (N, ...) array, the layout
    of raw (N, 2) wire-sample blocks. Returns (halo, ...)."""
    if halo <= 0:
        return x_local[:0]
    return wait(post(x_local[-halo:], mesh, axis), leftmost_fill)
