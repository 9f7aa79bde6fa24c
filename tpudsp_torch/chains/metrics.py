"""Per-block chain metrics (port of ``tpudsp/chains/metrics.py``).

Fields (None when a chain has no such loop):
- rssi: end-of-block input level estimate in dB (-20 log10 gain).
- squelch_modes: per-sample squelch FSM state tensor; host-side callbacks
  fire from this tensor after the block, never mid-loop.
- pll_freq: carrier-recovery loop frequency (rad/sample) at block end.
- resamp_credit: fractional-sample credit carried by the resampler (0 by
  construction for block lengths that make the output count integral).
- pilot_level: stereo-pilot amplitude (the WBFM stereo chain, chains/wbfm.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.agc import SQ_FALL, SQ_RISE


class BlockMetrics(NamedTuple):
    rssi: Optional[torch.Tensor]
    squelch_modes: Optional[torch.Tensor]
    pll_freq: Optional[torch.Tensor]
    resamp_credit: Optional[torch.Tensor]
    pilot_level: Optional[torch.Tensor] = None


def rssi_db(gain):
    """Liquid convention: rssi = -20 log10(gain)."""
    return -20.0 * torch.log10(torch.clamp_min(gain, 1e-30))


def squelch_events(modes) -> list:
    """Host-side event extraction from a squelch-mode tensor (N,) or (C, N):
    RISE and FALL are one-sample transition states, so each occurrence is
    one event. Returns a list of dicts ``{"kind": "rise"|"fall",
    "channel": int|None, "sample": int}`` ordered by sample position
    (channel=None for single-channel tensors)."""
    m = modes.cpu().numpy() if torch.is_tensor(modes) else np.asarray(modes)
    single = m.ndim == 1
    if single:
        m = m[None, :]
    events = []
    for kind, code in (("rise", SQ_RISE), ("fall", SQ_FALL)):
        ch, idx = np.nonzero(m == code)
        events += [{"kind": kind,
                    "channel": None if single else int(c),
                    "sample": int(i)} for c, i in zip(ch, idx)]
    events.sort(key=lambda e: (e["sample"], e["channel"] or 0))
    return events
