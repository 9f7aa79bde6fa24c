#!/usr/bin/env python
"""Wideband FM scanner: channelize a 100 Msps band into 1024 channels and
FM-demodulate every channel at once (BASELINE config 4). Beyond anything
the reference can express -- its per-sample chains top out near 2 Msps on
one channel.

Run: python examples_torch/fm_scanner.py"""

import sys

import numpy as np

sys.path.insert(0, ".")
from tpudsp_torch.chains import (  # noqa: E402
    ChannelizedBank, ChannelizedBankConfig, ChannelizerConfig,
)


def main():
    C = 1024
    iq_rate = 100e6
    chan_rate = iq_rate / C
    cfg = ChannelizedBankConfig(
        channelizer=ChannelizerConfig(nchan=C, iq_rate=iq_rate),
        demod="fm", kd=25_000.0 / chan_rate)

    # synthesize three FM stations on channel centers
    n = C * 512
    t = np.arange(n)
    stations = {100: 1000.0, 500: 2500.0, 900: 700.0}
    x = sum(np.exp(1j * (2 * np.pi * (c / C) * t
                         + 2 * np.pi * (25e3 / iq_rate)
                         * np.cumsum(np.sin(2 * np.pi * f / iq_rate * t))))
            for c, f in stations.items())
    iq = (np.asarray(x) / len(stations)).astype(np.complex64)

    # 1) activity scan on the channelized spectrum (carrier power per channel)
    from tpudsp_torch.chains import Channelizer
    ch = Channelizer(cfg.channelizer, block_len=n)
    Y = np.asarray(ch(iq).cpu())
    act = np.mean(np.abs(Y[64:]) ** 2, axis=0)
    hot = np.argsort(act)[-len(stations):]
    print("active channels:", sorted(int(c) for c in hot),
          "(expected", sorted(stations), ")")

    # 2) demodulate every channel (profiler annotation around the jitted
    # step; per-block metrics line to stderr)
    from tpudsp_torch.utils.profiling import annotate, stage_report
    bank = ChannelizedBank(cfg, block_len=n)
    with annotate("fm_scanner.bank_block"):
        audio = np.asarray(bank(iq).cpu())  # (1024, n/1024) at ~97.7 kHz/channel
    stage_report("fm_scanner.block", out=audio,
                 extra={"channels": int(audio.shape[0])})
    print(f"channelized {n} samples -> audio {audio.shape}")
    for c, f in stations.items():
        tail = audio[c, 128:]
        spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
        fr = np.fft.rfftfreq(len(tail), 1 / chan_rate)
        print(f"  ch{c}: audio peak {fr[np.argmax(spec[2:]) + 2]:.0f} Hz "
              f"(sent {f:.0f} Hz)")


if __name__ == "__main__":
    main()
