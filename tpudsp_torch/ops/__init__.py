"""Reference-compatible op surface (port of ``tpudsp/ops``): the 29
classes + 1 free function of the reference's module, with the JAX
package's names, kwargs and defaults. Every op runs on the card unless it
is built with ``device=`` (``ops/base.DEFAULT_DEVICE``).
"""

from .agc_op import AGC
from .demod import AmpModem, BroadcastAM, FMStereo, FreqDem, SSBDemod
from .filters import (
    CBandpassIIR,
    CBandstopIIR,
    CHighpassIIR,
    CIIRFilter,
    CLowpassIIR,
    ComplexIIRFilter,
    DeemphasisFilter,
    RBandpassIIR,
    RBandstopIIR,
    RealDCBlocker,
    RealFIRFilter,
    RealIIRFilter,
    RealKaiserBessel,
    RHighpassIIR,
    RIIRFilter,
    RLowpassIIR,
)
from .nco_op import NCO
from .resample import ComplexResampler, CResampler, RealResampler, RResampler
from .util import Delay, HilbertTransform, bytes_to_iq

__all__ = [
    "AGC", "AmpModem", "BroadcastAM", "CBandpassIIR", "CBandstopIIR",
    "CHighpassIIR", "CIIRFilter", "CLowpassIIR", "ComplexIIRFilter",
    "ComplexResampler", "CResampler", "DeemphasisFilter", "Delay",
    "FMStereo", "FreqDem", "HilbertTransform", "NCO", "RBandpassIIR",
    "RBandstopIIR", "RealDCBlocker", "RealFIRFilter", "RealIIRFilter",
    "RealKaiserBessel", "RealResampler", "RHighpassIIR", "RIIRFilter",
    "RLowpassIIR", "RResampler", "SSBDemod", "bytes_to_iq",
]
