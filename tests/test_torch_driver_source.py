"""The port's driver-shaped streaming source (tpudsp_torch.io.driver): a
mock pyrtlsdr-contract driver feeding the port's StreamRuntime through
RadioSource, on the CPU (mirrors of tests/test_driver_source.py), with the
three real-driver behaviors -- variable-size callbacks, overflow, and
sample-rate drift -- exercised end to end. The mock's wire bytes equal
the JAX package's mock's for the same render and seed, and the bank's
audio through RadioSource equals serial calls bit for bit."""

import threading
import time

import numpy as np
import pytest
import torch

from tpudsp.io import MockRTLSDRDriver as JMockRTLSDRDriver
from tpudsp_torch.chains import BankConfig, ReceiverBank
from tpudsp_torch.io import MockRTLSDRDriver, RadioSource, StreamRuntime

FS = 2_400_000.0
FREQS = (-600_000.0, 0.0, 500_000.0)


def _render(n0, n):
    """3-station scene: AM at 0, FM at +-; values within [-1, 1]."""
    t = (n0 + np.arange(n)) / FS
    m0 = np.sin(2 * np.pi * 900.0 * t)
    am = (1.0 + 0.5 * m0) * 0.25 * np.exp(2j * np.pi * 30.0 * t)
    fm1 = 0.25 * np.exp(1j * (2 * np.pi * FREQS[0] * t
                              + 3.0 * np.sin(2 * np.pi * 1100.0 * t)))
    fm2 = 0.25 * np.exp(1j * (2 * np.pi * FREQS[2] * t
                              + 3.0 * np.sin(2 * np.pi * 1500.0 * t)))
    return am + fm1 + fm2


def _bank():
    cfg = BankConfig(freqs=FREQS, iq_rate=FS, demod=("fm", "am", "fm"),
                     kd=75_000.0 / 240_000.0)
    return ReceiverBank(cfg, block_len=120_000, input_format="u8", device="cpu")


def _chunks(driver, num_bytes):
    """Every chunk the driver delivers, with the context it passes."""
    out = []
    driver.read_bytes_async(lambda b, ctx: out.append((b, ctx)), num_bytes=num_bytes)
    return out


@pytest.mark.parametrize("kw", [
    dict(variable=True), dict(variable=False), dict(variable=True, drift_ppm=200.0, seed=3),
    dict(variable=True, drift_ppm=-150.0, seed=9), dict(variable=True, burst_chunks=5, seed=4),
], ids=["variable", "fixed", "drift+", "drift-", "burst"])
def test_mock_wire_bytes_equal_tpudsp(kw):
    """Chunk for chunk, the port's mock delivers the JAX package's bytes."""
    ours = _chunks(MockRTLSDRDriver(_render, 300_001, sample_rate=FS, **kw), 65_536)
    theirs = _chunks(JMockRTLSDRDriver(_render, 300_001, sample_rate=FS, **kw), 65_536)
    assert [len(b) for b, _ in ours] == [len(b) for b, _ in theirs]
    assert all(a == b for (a, _), (b, _) in zip(ours, theirs))
    assert sum(len(b) for b, _ in ours) == 2 * 300_001


def test_mock_driver_end_to_end_matches_serial():
    """Variable-size driver chunks through the ring must produce exactly
    the audio of serial block calls on the same wire bytes (no drops:
    ample capacity)."""
    total = 480_000
    drv = MockRTLSDRDriver(_render, total, sample_rate=FS, variable=True)
    bank = _bank()
    rt = StreamRuntime(bank, sample_format="uint8_raw",
                       capacity_blocks=16)
    src = RadioSource(rt)
    src.run_async(drv, chunk_bytes=100_000)
    # wait for the mock stream to finish, then drain
    drv_done = []
    for _ in range(600):
        if src.bytes_delivered >= 2 * total:
            drv_done.append(True)
            break
        time.sleep(0.05)
    assert drv_done, "mock driver did not finish delivering"
    src.stop(drain=True)
    audio = list(rt)
    assert src.stats["overflow_chunks"] == 0
    assert src.stats["dropped_bytes"] == 0
    n_blocks = total // 120_000
    assert len(audio) == n_blocks
    streamed = np.concatenate(audio, axis=1)

    # serial reference on the identical wire bytes
    drv2 = MockRTLSDRDriver(_render, total, sample_rate=FS, variable=False)
    wire = b"".join(b for b, _ in _chunks(drv2, 2 * total))
    bank2 = _bank()
    blocks = []
    for k in range(n_blocks):
        w = np.frombuffer(wire[k * 240_000:(k + 1) * 240_000],
                          np.uint8).reshape(-1, 2).copy()
        blocks.append(bank2(torch.from_numpy(w)).numpy())
    serial = np.concatenate(blocks, axis=1)
    assert streamed.shape == serial.shape
    assert np.array_equal(streamed, serial)


def test_mock_driver_overflow_drops_whole_chunks():
    """A burst beyond the ring capacity must drop whole chunks (counted)
    and keep the stream frame-aligned -- the audio that does come out is
    finite and the runtime keeps running."""
    total = 720_000
    drv = MockRTLSDRDriver(_render, total, sample_rate=FS, variable=True,
                           burst_chunks=10 ** 9)  # never pace: full burst
    bank = _bank()
    held = threading.Event()

    def slow_bank(iq):
        # the bank's plain CPU form keeps pace with the mock's burst once
        # warm: hold the pump until the burst is over, as a card that
        # falls behind would
        held.wait(timeout=60)
        return bank(iq)

    # tiny ring: 2 blocks worth
    rt = StreamRuntime(slow_bank, block_len=bank.block_len, sample_format="uint8_raw",
                       capacity_blocks=2, device="cpu")
    src = RadioSource(rt)
    # deliver synchronously on this thread: the burst outruns the pump
    drv.read_bytes_async(src, num_bytes=100_000)
    held.set()
    src.stop(drain=True)
    audio = list(rt)
    st = src.stats
    assert st["overflow_chunks"] > 0
    assert st["overflow_bytes"] == st["dropped_bytes"]
    # whole-chunk drops: everything that came through is sane audio
    assert len(audio) >= 1
    for a in audio:
        assert np.isfinite(a).all()


def test_mock_driver_drift_keeps_tones():
    """+200 ppm crystal drift: the push pipeline neither stalls nor
    misframes; the AM channel still demodulates its 900 Hz message."""
    total = 480_000
    drv = MockRTLSDRDriver(_render, total, sample_rate=FS, variable=True,
                           drift_ppm=200.0, seed=3)
    bank = _bank()
    rt = StreamRuntime(bank, sample_format="uint8_raw", capacity_blocks=16)
    src = RadioSource(rt)
    drv.read_bytes_async(src, num_bytes=131072)  # synchronous full stream
    src.stop(drain=True)
    audio = np.concatenate(list(rt), axis=1)
    am = audio[1] - audio[1].mean()
    half = am[len(am) // 2:]
    S = np.abs(np.fft.rfft(half * np.hanning(len(half))))
    f = np.fft.rfftfreq(len(half), 50.0 / FS)  # decim1*decim2 = 50
    peak = f[np.argmax(S)]
    # 900 Hz within a couple of bins (drift shifts it by 0.02%)
    assert abs(peak - 900.0) < 25.0, peak


def test_radiosource_rejects_garbage():
    bank = _bank()
    rt = StreamRuntime(bank, sample_format="uint8_raw")
    src = RadioSource(rt)
    with pytest.raises(TypeError):
        src(3.14)
    src.stop(drain=False)


def test_radiosource_absorbs_push_after_stop():
    """A driver callback that fires after the runtime stopped must NOT
    raise into the driver thread: the chunk is counted dropped and the
    error is surfaced through .error/stats."""
    bank = _bank()
    rt = StreamRuntime(bank, sample_format="uint8_raw")
    src = RadioSource(rt)
    rt.stop(drain=False)
    got = src(b"\x7f" * 480)  # late delivery, absorbed
    assert got == 0
    assert src.error is not None
    assert src.stats["error"] is not None
    assert src.overflow_chunks == 1
