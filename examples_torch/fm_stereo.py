#!/usr/bin/env python
"""WBFM stereo broadcast receiver, production mode: raw radio bytes ->
StreamRuntime -> FM stereo decode -> stereo WAV.

The reference's FMStereo (demod.hpp:4-85, wrapper.cpp:264-267) emits
interleaved L,R floats and leaves the plumbing to the user. Here the
chain's (N, 2) device-native output flows through the streaming executor
into a 2-channel WAV, with per-block pilot-lock telemetry from
BlockMetrics (pilot_level / pll_freq).

Run: python examples_torch/fm_stereo.py  (synthesizes IQ; writes fm_stereo.wav)
"""

import sys

import numpy as np

sys.path.insert(0, ".")


def synth_stereo_iq(n, iq_rate):
    """Broadcast-style composite: L=900 Hz, R=2500 Hz, 19 kHz pilot."""
    t = np.arange(n)
    la = np.sin(2 * np.pi * 900.0 / iq_rate * t)
    ra = np.sin(2 * np.pi * 2500.0 / iq_rate * t)
    f_p = 19000.0 / iq_rate
    comp = ((la + ra) / 2 + 0.1 * np.cos(2 * np.pi * f_p * t)
            + ((la - ra) / 2) * np.cos(2 * np.pi * 2 * f_p * t)) * 0.008
    iq = np.exp(1j * 2 * np.pi * np.cumsum(comp))
    raw = np.empty(2 * n, np.int16)
    raw[0::2] = np.clip(iq.real * 32767 * 0.5, -32767, 32767)
    raw[1::2] = np.clip(iq.imag * 32767 * 0.5, -32767, 32767)
    return raw.tobytes()


def main():
    from tpudsp_torch.chains.wbfm import WBFMStereoReceiver
    from tpudsp_torch.io import StreamRuntime, WavSink

    iq_rate, pcm_rate = 2_400_000, 48_000
    n = 4_000_000
    raw = synth_stereo_iq(n, iq_rate)

    locks = []

    with WavSink("fm_stereo.wav", pcm_rate) as sink:  # channels inferred
        def on_audio(pcm, meta):
            sink(pcm)
            m = meta["metrics"]
            if m is not None:
                locks.append((float(m.pilot_level), float(m.pll_freq)))

        rt = StreamRuntime(WBFMStereoReceiver(block_len=1_000_000),
                           on_audio=on_audio)
        step = 1 << 18
        for i in range(0, len(raw), 8 * step):
            rt.push(raw[i:i + 8 * step])
        rt.stop(drain=True)

    for b, (lvl, freq) in enumerate(locks):
        print(f"block {b}: pilot_level={lvl:.4f} "
              f"pilot_offset={freq * iq_rate / 4 / (2 * np.pi):+.2f} Hz")
    print(f"{rt.blocks_processed} blocks -> {sink.frames_written} stereo "
          f"frames -> fm_stereo.wav  stats={rt.stats}")


if __name__ == "__main__":
    main()
