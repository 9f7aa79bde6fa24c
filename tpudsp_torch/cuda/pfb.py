"""The polyphase filter bank's branch sum on the card: the CUDA kernel
``csrc/pfb_branch.cu``.

The JAX package runs it as T shifted multiply-adds that XLA fuses into one
pass (``tpudsp/chains/channelizer.py`` ``channelize``, ``channelize_i16``);
the port runs it as one hand-written kernel launch a block, which reads
the carried tail and the block in place (no copy of tail ++ x) and writes
u (M, C) complex64, the input of the channel IFFT. A thread of the kernel
walks a run of frames of one branch with its taps and its window of
samples in registers, so it takes at most MAX_TAPS taps a branch.

Dispatch: CPU tensors take the plain version ``kernels/pfb.
branch_accumulate``; CUDA tensors launch the kernel or raise. There is no
fallback.
"""

from __future__ import annotations

import torch

from ..kernels import pfb as kpfb
from . import launch

KERNEL = "pfb_branch"
MAX_TAPS = 16   # the largest T the kernel has an instance for
# the kernel's input kinds, by the wire type
_KINDS = {torch.complex64: 0, torch.int16: 1, torch.uint8: 2}


def branch_accumulate(Ht, tail, x, os: int):
    """u[m, p] = sum_t Ht[t, p] (tail ++ x)[(m + os (T-1-t)) C/os + C-1-p]
    as kernels/pfb.branch_accumulate computes it: Ht (T, C) f32; tail
    ((T-1) C + C-1,) and x (N,) complex64, or raw (.., 2) int16 / uint8.
    Returns u (N os / C, C) complex64."""
    if x.device.type == "cpu":
        return kpfb.branch_accumulate(Ht, tail, x, os)
    dev = x.device
    launch.on_cuda(KERNEL, dev)
    T, C = Ht.shape
    kind = _KINDS.get(x.dtype)
    if kind is None:
        raise ValueError(f"{KERNEL}: x must be complex64, int16 or uint8, got {x.dtype}")
    if os not in (1, 2) or C % os:
        raise ValueError(f"{KERNEL}: oversampling {os} does not divide {C} channels")
    if T > MAX_TAPS:
        raise ValueError(f"{KERNEL}: {T} taps a branch, the kernel takes at most {MAX_TAPS}")
    n = x.shape[0]
    wire = () if kind == 0 else (2,)
    htail = (T - 1) * C + C - 1
    launch.check(KERNEL, "Ht", Ht, torch.float32, (T, C), dev)
    launch.check(KERNEL, "tail", tail, x.dtype, (htail, *wire), dev)
    launch.check(KERNEL, "x", x, x.dtype, (n, *wire), dev)
    M = n * os // C
    u = torch.empty((M, C), dtype=torch.complex64, device=dev)
    launch.launch(KERNEL, dev, Ht, tail, x, u, kind, T, C, os, M)
    branch_accumulate.launches += 1
    return u


branch_accumulate.launches = 0
