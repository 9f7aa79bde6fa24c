"""Pure (params, state, block) -> (state, block) functions on tensors: the
counterparts of ``tpudsp.kernels``, in plain PyTorch. The sequential scans
here are the plain versions of the CUDA kernels in ``cuda/``;
``ampmodem.ampdemod_apply`` reaches its carrier-PLL kernel through
``cuda/pll_scan`` and its DC tracker's through ``cuda/first_order``."""

import torch
import torch.nn.functional as F


def f32_matmul(a, b):
    """a @ b in full float32. TF32 would keep ~10 mantissa bits and cost the
    AM chain its 100 dB pin, so it is switched off before every product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a, b)


def f32_conv1d(x, w, stride: int = 1):
    """``F.conv1d(x, w, stride=stride)`` (a cross-correlation, as lax.conv in
    "VALID" mode) in full float32: cuDNN runs float32 convolutions in TF32
    unless told otherwise, so that is switched off before every call."""
    torch.backends.cudnn.allow_tf32 = False
    return F.conv1d(x, w, stride=stride)
