#!/usr/bin/env python
"""RTL-SDR multi-station scanner from RAW uint8 wire bytes, driven
through the full driver stack: a pyrtlsdr-contract driver (mocked here;
swap in a real ``RtlSdr`` object unchanged) delivering variable-size
byte chunks into RadioSource -> StreamRuntime -> jitted bank.

The dongle's native stream is interleaved uint8 IQ ((b - 127.5)/127.5 —
standard RTL-SDR practice, matching tpudsp_torch's own io.u8_to_iq; the
reference has no uint8 helper, its host-side bytes_to_iq is int16-only,
utility.hpp:61-69). Here NO host conversion happens at all: the bytes
flow through the native SPSC ring into the jitted bank as (N, 2) uint8,
and the affine conversion folds into the front-end matmul on-chip
(kernels/decimate.py strided_cfir_matmul_wide_u8) — 2 B/sample over
host->device and HBM instead of 8.

With a real dongle this program is:

    from rtlsdr import RtlSdr
    sdr = RtlSdr(); sdr.sample_rate = fs; sdr.center_freq = ...
    src.run_async(sdr, chunk_bytes=262144)   # instead of the mock

Run: python examples_torch/rtl_scanner.py"""

import sys

import numpy as np

sys.path.insert(0, ".")
from tpudsp_torch.chains import BankConfig, ReceiverBank  # noqa: E402
from tpudsp_torch.io import MockRTLSDRDriver, RadioSource, StreamRuntime  # noqa: E402

FS = 2_400_000.0


def render(n0, n):
    """Three stations: FM at -600 kHz (1.2 kHz tone), AM at DC (800 Hz),
    FM at +500 kHz (2 kHz tone); absolute-indexed so the driver can
    deliver it in arbitrary chunks."""
    t = (n0 + np.arange(n)) / FS
    fm1 = 0.3 * np.exp(-2j * np.pi * 600e3 * t
                       + 1j * (75e3 / 1.2e3) * 0.8
                       * np.sin(2 * np.pi * 1.2e3 * t))
    am = 0.25 * (1 + 0.6 * np.sin(2 * np.pi * 800.0 * t))
    fm2 = 0.3 * np.exp(2j * np.pi * 500e3 * t
                       + 1j * (75e3 / 2e3) * 0.8
                       * np.sin(2 * np.pi * 2e3 * t))
    return 0.45 * (fm1 + am + fm2)


def main():
    cfg = BankConfig(freqs=(-600_000.0, 0.0, 500_000.0), iq_rate=FS,
                     demod=("fm", "am", "fm"), kd=75_000.0 / 240_000.0)
    block = 240_000
    n_blocks = 4

    bank = ReceiverBank(cfg, block_len=block, input_format="u8")
    blocks = []
    rt = StreamRuntime(bank, sample_format="uint8_raw",
                       on_audio=lambda a, meta: blocks.append(np.asarray(a.cpu())))
    src = RadioSource(rt)
    # pyrtlsdr-shaped driver: variable-size ~262144-byte buffers on its
    # own delivery loop (a real RtlSdr slots in here unchanged)
    sdr = MockRTLSDRDriver(render, n_blocks * block, sample_rate=FS,
                           center_freq=100e6, variable=True)
    src.run_async(sdr, chunk_bytes=262144)
    import time
    while src.bytes_delivered < 2 * n_blocks * block:
        time.sleep(0.02)
    src.stop(drain=True)
    audio = np.concatenate(blocks, axis=1)

    fs_a = cfg.audio_rate
    names = ("FM -600k", "AM 0", "FM +500k")
    expect = (1200.0, 800.0, 2000.0)
    tail = audio[:, audio.shape[1] // 2:]
    ok = True
    for c, (name, f) in enumerate(zip(names, expect)):
        a = tail[c] - tail[c].mean()
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        peak = np.fft.rfftfreq(len(a), 1 / fs_a)[np.argmax(spec)]
        print(f"  {name}: tone {peak:7.1f} Hz (expect {f:.0f})")
        ok &= abs(peak - f) < 25.0
    print("driver chunks:", src.chunks_delivered, "-> audio", audio.shape,
          "| stats:", src.stats)
    if not ok:
        raise SystemExit("station tone mismatch")
    print("RTL-SDR u8 wire-format scan (mock driver end-to-end): OK")


if __name__ == "__main__":
    main()
