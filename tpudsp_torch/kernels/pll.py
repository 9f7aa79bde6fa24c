"""Carrier-PLL state (port of ``tpudsp/kernels/pll.py``).

Gains follow the liquid nco convention: freq gain alpha = bw, phase gain
beta = sqrt(bw). The loop itself runs inside the fused AM front
(``kernels/am_backend.front_sample_step`` and its CUDA kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PllState(NamedTuple):
    theta: torch.Tensor  # f32, radians (wrapped)
    freq: torch.Tensor   # f32, radians/sample


def pll_init(device=None) -> PllState:
    zero = dict(dtype=torch.float32, device=device)
    return PllState(theta=torch.tensor(0.0, **zero),
                    freq=torch.tensor(0.0, **zero))
