"""Receiver chains (port of ``tpudsp.chains``): the AM receiver (BASELINE
config 1), WBFM mono and stereo (config 2), the multi-channel receiver
bank (config 3), the polyphase channelizer and its demod bank (config 4)
and the SSB receiver. Each runs on the card unless the
caller asks for the CPU (``device=``)."""

from .am import AMConfig, AMReceiver, am_step_composed, am_step_fused, build as am_build
from .bank import BankConfig, ReceiverBank, bank_step, build as bank_build
from .channelizer import (
    ChannelizedBank, ChannelizedBankConfig, Channelizer, ChannelizerConfig,
)
from .metrics import BlockMetrics, squelch_events
from .ssb import SSBConfig, SSBReceiver
from .wbfm import WBFMStereoReceiver, mono_receiver

__all__ = [
    "AMConfig", "AMReceiver", "am_step_composed", "am_step_fused", "am_build",
    "BankConfig", "BlockMetrics", "ReceiverBank", "bank_step", "bank_build",
    "ChannelizedBank", "ChannelizedBankConfig", "Channelizer",
    "ChannelizerConfig", "SSBConfig", "SSBReceiver", "WBFMStereoReceiver", "mono_receiver",
    "squelch_events",
]
