"""The receiver bank's output rotation and FM discriminator on the card:
the CUDA kernel ``csrc/bank_rotate.cu``.

``fm_base`` takes the channel filter's output y1m (C, nj) complex64 of
``chains/bank.bank_step`` to the FM rows that its audio decimator reads,
in one launch: the uint32 phase lattice, the rotation by it and the
discriminator, with the last rotated sample of each channel (the next
block's discriminator carry). The JAX package runs the same step in XLA;
it has no Pallas kernel.

Dispatch: CPU tensors take the plain version ``kernels/bank_rotate.
fm_base``; CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import bank_rotate as kbr
from ..kernels.nco import _U32_TO_RAD
from . import launch

KERNEL = "bank_rotate"


def _launch(y1m, phase, n0, dtheta, D1: int, fd_prev, kd: float):
    """One launch of the kernel over y1m (C, nj); counts it in
    ``_launch.launches``. Returns (the (C, nj) f32 rows, the (C,)
    complex64 last rotated samples)."""
    dev = y1m.device
    launch.on_cuda(KERNEL, dev)
    if y1m.dim() != 2 or y1m.shape[1] == 0:
        raise ValueError(f"{KERNEL}: y1m must be (C, nj) with nj >= 1, got "
                         f"{tuple(y1m.shape)}")
    C, nj = y1m.shape
    launch.check(KERNEL, "y1m", y1m, torch.complex64, (C, nj), dev)
    launch.check(KERNEL, "phase", phase, torch.int64, (C,), dev)
    launch.check(KERNEL, "n0", n0, torch.int64, (), dev)
    launch.check(KERNEL, "dtheta", dtheta, torch.int64, (C,), dev)
    launch.check(KERNEL, "fd_prev", fd_prev, torch.complex64, (C,), dev)
    # the last samples apart from the rows: the next block's carry keeps
    # only its own C values alive
    base = torch.empty((C, nj), dtype=torch.float32, device=dev)
    fd_last = torch.empty((C,), dtype=torch.complex64, device=dev)
    launch.launch(KERNEL, dev, y1m, phase, n0, dtheta, fd_prev, base, fd_last, C, nj, D1,
                  _U32_TO_RAD, float(np.float32(2.0 * np.pi * kd)))
    _launch.launches += 1
    return base, fd_last


_launch.launches = 0


def fm_base(y1m, phase, n0, dtheta, D1: int, fd_prev, kd: float):
    """The FM rows of y1m (C, nj) complex64 rotated by the phase lattice
    (phase, dtheta (C,) and n0 0-d, int64 in [0, 2^32)), after fd_prev (C,)
    complex64, as kernels/bank_rotate.fm_base computes them: on CUDA one
    launch. Returns (the (C, nj) f32 rows, the (C,) complex64 last rotated
    samples)."""
    if y1m.device.type == "cpu":
        return kbr.fm_base(y1m, phase, n0, dtheta, D1, fd_prev, kd)
    return _launch(y1m, phase, n0, dtheta, D1, fd_prev, kd)
