#!/usr/bin/env python
"""The reference README's AMRadio receiver (README.md:33-64), verbatim
against tpudsp_torch.compat -- the drop-in migration path for liquiddsp users.

Run: python examples_torch/am_radio.py  (synthesizes IQ; writes pcm.f32)"""

import sys

import numpy as np

sys.path.insert(0, ".")
import tpudsp_torch.compat as liquiddsp  # noqa: E402


class AMRadio:
    def __init__(self, bandwidth=15000, iq_rate=2000000, pcm_rate=48000):
        self.bandpass = liquiddsp.ComplexIIRFilter(
            filter_type="cheby2", order=8, Fc=bandwidth / iq_rate)
        self.resample = liquiddsp.ComplexResampler(
            rate=pcm_rate / iq_rate, Fc=pcm_rate / iq_rate)
        self.am = liquiddsp.AmpModem(modulation=0.5, type="dsb", carrier=True)
        self.audio_filter = liquiddsp.DeemphasisFilter(pcm_rate)
        self.agc = liquiddsp.AGC()
        self.agc.lock = False
        self.agc.scale = 0.01
        self.pcm = b""

    def __call__(self, iq):
        pcm = self.audio_filter(self.am(self.agc(self.resample(self.bandpass(iq)))))
        self.pcm += pcm.tobytes()
        return pcm


def main():
    iq_rate, pcm_rate = 2_000_000, 48_000
    n = 1 << 21
    t = np.arange(n)
    msg = np.sin(2 * np.pi * 1000.0 / iq_rate * t)  # 1 kHz program audio
    iq = ((1 + 0.5 * msg) * 0.3
          * np.exp(2j * np.pi * 200.0 / iq_rate * t))
    raw = np.empty(2 * n, np.int16)
    raw[0::2] = np.clip(iq.real * 32767, -32767, 32767)
    raw[1::2] = np.clip(iq.imag * 32767, -32767, 32767)

    from tpudsp_torch.utils.profiling import stage_report

    radio = AMRadio()
    block = 1 << 18
    for i in range(0, n, block):
        out = radio(liquiddsp.bytes_to_iq(raw[2 * i: 2 * (i + block)].tobytes()))
        # per-block observability: output level + live AGC rssi/status
        stage_report("am_radio.block", out=out,
                     extra={"rssi_db": round(radio.agc.level_dB, 2),
                            "agc_status": radio.agc.status,
                            "block": i // block})

    pcm = np.frombuffer(radio.pcm, np.float32)
    with open("pcm.f32", "wb") as f:
        f.write(radio.pcm)
    print(f"{n} IQ samples -> {len(pcm)} PCM samples at {pcm_rate} Hz "
          f"(rms {np.sqrt((pcm[len(pcm)//2:]**2).mean()):.4f}) -> pcm.f32")

    # Production mode: the same signal through the streaming runtime -- a
    # radio-driver thread pushes raw bytes, the pump thread frames blocks
    # and dispatches the single-jit AMReceiver chain, audio lands in a
    # playable WAV (tpudsp_torch/io/stream.py, wav.py).
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.io import StreamRuntime, WavSink

    with WavSink("pcm.wav", pcm_rate) as sink:
        # AMReceiver needs block_len * rate integral (planned shapes)
        rt = StreamRuntime(AMReceiver(AMConfig(), block_len=250_000),
                           on_audio=sink)
        for i in range(0, n, 1 << 16):
            rt.push(raw[2 * i: 2 * (i + (1 << 16))].tobytes())
        rt.stop(drain=True)
    print(f"streaming runtime: {rt.blocks_processed} blocks, "
          f"{sink.frames_written} PCM frames -> pcm.wav  stats={rt.stats}")


if __name__ == "__main__":
    main()
