"""tpudsp_torch -- the PyTorch/CUDA port of tpudsp for NVIDIA Hopper.

The package mirrors ``tpudsp``'s module names (``design``, ``kernels``,
``chains``, ``ops``, ``compat``), so every counterpart sits at the same
path. ``tpudsp`` stays
the numerical reference the port is tested against; this package imports
``torch`` and never ``jax``.

Plain tensor code is PyTorch. Each Pallas kernel of ``tpudsp/pallas/``
becomes a hand-written CUDA kernel under ``csrc/``, built at first use by
``cuda/build.py`` and launched through a wrapper in ``cuda/``. A wrapper
runs the kernel's plain PyTorch version when its input lies on the CPU,
and launches the kernel (or raises) when it lies on a CUDA device.

Ported so far: the single-channel AM receiver (``chains.am.AMReceiver``)
with every plan, exact and back-end option of the JAX receiver, on c64,
i16 and u8 input, with the AGC + squelch + carrier-PLL feedback core as
the CUDA kernel ``csrc/am_front_scan.cu``; the whole reference class
surface (``compat``: the 29 classes and bytes_to_iq), with the AGC scan
(``csrc/agc_scan.cu``), the carrier-PLL scan (``csrc/pll_scan.cu``) and
the compensated SOS cascade of the IIR scan mode and BroadcastAM
(``csrc/biquad_scan.cu``) as CUDA kernels; and the AM receiver
time-sharded on torch.distributed (``parallel.ShardedAMReceiver``), with
the async-halo front end as the CUDA kernel ``csrc/halo_async.cu``. Their
DC trackers, de-emphasis and FMStereo's pilot smoothers are the blocked
first-order scan ``csrc/first_order_scan.cu`` (the AM receiver's whole
linear tail in one launch; a complex64 entry for the pilot). The other
receiver chains: the multi-channel bank (``chains.bank.ReceiverBank``,
its front end one halo_async launch on one card), WBFM mono and stereo
(``chains.wbfm``), the SSB receiver (``chains.ssb``) and the polyphase
channelizer with its 1024-channel demod bank (``chains.channelizer``),
whose branch sum is the CUDA kernel ``csrc/pfb_branch.cu`` and whose FM
de-emphasis is one first_order_scan launch over the channels' rows. The
io layer (``io``: the streaming runtime, the native ingest ring, the
driver-shaped source, WAV sinks, checkpoints) drives any of them from a
radio's raw bytes, and ``utils`` holds the profiling helpers.
Everything runs on the card ("cuda") unless the caller asks for the CPU.
"""

from .chains import (  # noqa: F401
    AMConfig, AMReceiver, BankConfig, ChannelizedBank, ChannelizedBankConfig, Channelizer,
    ChannelizerConfig, ReceiverBank, SSBConfig, SSBReceiver, WBFMStereoReceiver,
    mono_receiver,
)

__all__ = ["AMConfig", "AMReceiver", "BankConfig", "ChannelizedBank",
           "ChannelizedBankConfig", "Channelizer", "ChannelizerConfig", "ReceiverBank",
           "SSBConfig", "SSBReceiver", "WBFMStereoReceiver", "mono_receiver"]
