"""The polyphase filter bank's branch sum (the part of ``tpudsp/chains/
channelizer.py`` ``channelize`` / ``channelize_i16`` before the channel
IFFT), in plain PyTorch: the plain version of the CUDA kernel
``csrc/pfb_branch.cu``, which ``cuda/pfb`` launches on a CUDA tensor.

With C channels, T taps a branch, oversampling os (hop R = C / os) and
the carried raw samples ``tail`` of length htail = (T-1) C + C-1 before the
block x, branch p of frame m of the commutator reads xfull[m R + C-1-p]
(xfull = tail ++ x), and

    u[m, p] = sum over t = 0..T-1 of Ht[t, p] xfull[(m + os (T-1-t)) R + C-1-p]

in that order from u = 0, each product and each sum rounded on its own,
re and im apart: the JAX package's T shifted multiply-adds over its
reversed (M, C) frame matrix. Raw int16 / uint8 (N, 2) samples convert to
f32 at the product; for uint8 127.5 times the branch's tap sum (summed in
order t = 0..T-1) is then subtracted from both parts.
"""

from __future__ import annotations

import torch


def frame_index(M: int, T: int, C: int, os: int, device=None):
    """The (M + os (T-1), C) indices into xfull of the commutator's frames:
    frame m, branch p at m R + C-1-p."""
    R = C // os
    m = torch.arange(M + os * (T - 1), device=device)
    return m[:, None] * R + (C - 1 - torch.arange(C, device=device))[None, :]


def branch_sums(Ht):
    """sum_t Ht[t, p] in order t = 0..T-1, f32 (C,): the uint8 offset's
    per-branch factor, as the kernel sums it."""
    s = torch.zeros_like(Ht[0])
    for t in range(Ht.shape[0]):
        s = s + Ht[t]
    return s


def branch_accumulate(Ht, tail, x, os: int):
    """u (M, C) complex64 before the channel IFFT, M = N os / C. Ht: (T, C)
    f32; tail and x: (htail,) and (N,) complex64, or raw (htail, 2) and
    (N, 2) int16 / uint8."""
    T, C = Ht.shape
    M = x.shape[0] * os // C
    V = torch.cat([tail, x])[frame_index(M, T, C, os, x.device)]
    V = torch.view_as_real(V) if V.is_complex() else V.float()   # (M_all, C, 2)
    u = torch.zeros((M, C, 2), dtype=torch.float32, device=x.device)
    for t in range(T):
        s = os * (T - 1 - t)
        u = u + Ht[t][None, :, None] * V[s:s + M]
    if x.dtype == torch.uint8:
        u = u - (127.5 * branch_sums(Ht))[None, :, None]
    return torch.view_as_complex(u)
