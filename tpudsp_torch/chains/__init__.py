"""Receiver chains (port of ``tpudsp.chains``): so far the fused AM
receiver (BASELINE config 1)."""

from .am import AMConfig, AMReceiver, am_step_fused, build as am_build
from .metrics import BlockMetrics, squelch_events

__all__ = ["AMConfig", "AMReceiver", "am_step_fused", "am_build",
           "BlockMetrics", "squelch_events"]
