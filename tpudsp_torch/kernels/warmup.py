"""Warmup-window sizing for the warmup-chunk scheme (port of
``tpudsp/kernels/warmup.py``).

A chunk's entry state re-derived from the ``warmup`` samples before it
matches the true state to a relative error ~ exp(-warmup / memory), where
``memory`` is the loop's longest time constant in samples:
  - AGC gain loop: 3/alpha (measured decay exp(-alpha n / 3)), plus the
    squelch countdown ``timeout`` when squelch is on;
  - carrier PLL (bw, alpha=bw, beta=sqrt(bw)): 3/sqrt(bw);
  - one-pole trackers (rho): 1/(1-rho). First-order LINEAR filters (DC
    tracker, de-emphasis) run as exact scans outside the chunked loop.

The TPU package also caps the warmup its VMEM kernels stage
(``PALLAS_WARMUP_MAX``). The CUDA kernels read their warmup windows from
device memory and need no cap; the port keeps the constant only so that
the AGC op picks the same route, and so the same chunk, as the JAX op.
"""

from __future__ import annotations

import numpy as np

# target relative error exp(-FACTOR) on top of each loop's memory
FACTOR = 12.0
AGC_MEMORY = 3.0   # samples x (1/alpha)
PLL_MEMORY = 3.0   # samples x (1/sqrt(bw))

# the JAX AGC op's bound for its Pallas route (tpudsp/kernels/warmup.py)
PALLAS_WARMUP_MAX = 6144


def _round_up(n: int, q: int) -> int:
    return -(-int(n) // q) * q


def warmup_for(agc_alpha: float | None = None,
               pll_bw: float | None = None,
               squelch_timeout: int = 0,
               dc_rho: float | None = None,
               factor: float = FACTOR,
               minimum: int = 256) -> int:
    """Warmup window (samples) covering every loop present, rounded up to
    a multiple of 256. Pass only the loops that are inside the chunked
    scan."""
    need = float(minimum)
    if agc_alpha:
        need = max(need, factor * AGC_MEMORY / float(agc_alpha)
                   + float(squelch_timeout))
    if pll_bw:
        need = max(need, factor * PLL_MEMORY / float(np.sqrt(pll_bw)))
    if dc_rho:
        need = max(need, factor / (1.0 - float(dc_rho)))
    return _round_up(need, 256)


def chunk_for(warmup: int, base: int = 1024) -> int:
    """Chunk length for the warmup-chunk scheme: grows with the warmup
    window so the redundant warmup work stays <= 2x of the payload."""
    return max(int(base), _round_up(warmup, 256))
