"""Rounding to a lower precision, for the control of the comparison.

A control is the reference computed below the precision the
configurations state (float32, with TF32 off in the matmul-like
products), at a step a later change would be tempted to take. Three are
read, and each has to fail every cell's limit:

- ``TF32``: TF32 (10 mantissa bits) for the operands of the filter
  products (the fused front's matmul, the channelizer's branch sum);
- ``FP16``: float16 (10) for the values passed between stages (the
  channels, the resampled baseband, the discriminator's and the chain's
  outputs), as an eager pass that stores its result in half would;
- ``TF32_BF16``: TF32 products and bfloat16 (7) between stages.

The sample-serial loops (AGC, PLL, DC tracker) keep their state in
float64: a loop state in bfloat16 breaks the loop outright, and a
control that only fails by breaking says nothing of the limit.
``Precision`` rounds float64 values to the given number of mantissa bits
(round to nearest even, through float32); ``F64`` leaves them as they
are, so the reference and its control are one code path.
"""

from __future__ import annotations

import numpy as np


def round_bits(x, bits: int):
    """x (real or complex, any shape) rounded to ``bits`` mantissa bits,
    as float64 / complex128."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return round_bits(x.real, bits) + 1j * round_bits(x.imag, bits)
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    drop = 23 - bits
    half = np.uint64(1 << (drop - 1))
    odd = (u >> np.uint64(drop)) & np.uint64(1)
    u = ((u + half - np.uint64(1) + odd) >> np.uint64(drop)) << np.uint64(drop)
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


class Precision:
    """``mm`` rounds the operands of a filter product, ``el`` the values
    between stages, ``loop`` a sample-serial loop's state; None keeps
    float64."""

    def __init__(self, bits_mm=None, bits_el=None, bits_loop=None, name="float64"):
        self.bits_mm, self.bits_el, self.name = bits_mm, bits_el, name
        self.bits_loop = bits_loop

    def mm(self, x):
        return np.asarray(x) if self.bits_mm is None else round_bits(x, self.bits_mm)

    def el(self, x):
        return np.asarray(x) if self.bits_el is None else round_bits(x, self.bits_el)

    def loop(self, x):
        return np.asarray(x) if self.bits_loop is None else round_bits(x, self.bits_loop)

    @property
    def exact(self) -> bool:
        return self.bits_mm is None and self.bits_el is None and self.bits_loop is None


F64 = Precision()
TF32 = Precision(bits_mm=10, name="tf32 products")
FP16 = Precision(bits_el=10, name="float16 between stages")
TF32_BF16 = Precision(bits_mm=10, bits_el=7, name="tf32 products, bfloat16 between stages")
CONTROLS = (TF32, FP16, TF32_BF16)
