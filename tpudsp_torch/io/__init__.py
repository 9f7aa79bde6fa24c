"""IQ ingest, block framing, streaming runtime, WAV sinks and state
checkpointing (port of ``tpudsp.io``)."""

from .driver import MockRTLSDRDriver, RadioSource
from .ingest import IQStream, bytes_to_iq, u8_to_iq
from .stream import StreamRuntime
from .wav import WavSink, write_wav

__all__ = ["IQStream", "MockRTLSDRDriver", "RadioSource",
           "StreamRuntime", "WavSink", "bytes_to_iq",
           "u8_to_iq", "write_wav"]
