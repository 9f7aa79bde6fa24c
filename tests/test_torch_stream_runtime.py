"""The port's StreamRuntime (tpudsp_torch.io.stream) on the CPU: mirrors of
tests/test_stream_runtime.py at its BLOCK = 12_500 (all but its
ShardedScanner test, which runs on a four-rank gloo ring with the
scanner's other cases in tests/test_torch_scanner.py). The runtime must
reproduce the port's serial chain calls bit for bit (push order ==
processing order == state evolution), stay >= 80 dB from the JAX
package's StreamRuntime(AMReceiver(backend='pallas')) on the same bytes
(the bar of tests/test_torch_chain.py), honor backpressure, and surface
receiver errors on the caller thread. A plain callable runs on the device
its ``device=`` names: "cpu" here."""

import sys
import threading

import numpy as np
import pytest
import torch

from tests.util import snr_db
from tpudsp.chains import am as jam
from tpudsp.io import StreamRuntime as JStreamRuntime
from tpudsp_torch.chains.am import AMConfig, AMReceiver
from tpudsp_torch.io import StreamRuntime, bytes_to_iq

BLOCK = 12_500  # * 48k/2M = 300 output samples
N_BLOCKS = 6


def _am_bytes(n, seed=0):
    """AM-modulated int16 IQ bytes (1 kHz message, 200 Hz carrier offset),
    with a little numpy-seeded noise."""
    t = np.arange(n)
    msg = np.sin(2 * np.pi * 1000.0 / 2e6 * t)
    iq = ((1.0 + 0.5 * msg) * 0.3 * np.exp(2j * np.pi * 200.0 / 2e6 * t))
    rng = np.random.default_rng(seed)
    iq = iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    xs = np.empty(2 * n, np.int16)
    xs[0::2] = np.round(iq.real * 32767 * 0.5)
    xs[1::2] = np.round(iq.imag * 32767 * 0.5)
    return xs.tobytes()


def _rx(**kw):
    return AMReceiver(AMConfig(), block_len=BLOCK, device="cpu", **kw)


def _serial_reference(raw):
    rx = _rx()
    iq = bytes_to_iq(raw)
    return np.concatenate([
        rx(torch.from_numpy(iq[i * BLOCK:(i + 1) * BLOCK])).numpy()
        for i in range(N_BLOCKS)])


@pytest.fixture(scope="module")
def streamed():
    """The port's runtime over six blocks pushed in odd sizes from a radio
    thread, and the bytes."""
    raw = _am_bytes(N_BLOCKS * BLOCK)
    rt = StreamRuntime(_rx())

    def producer():  # radio-driver thread, odd-sized pushes
        step = 7_777 * 4
        for i in range(0, len(raw), step):
            while rt.push(raw[i:i + step]) == 0:
                pass

    th = threading.Thread(target=producer)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    rt.stop(drain=True)
    return raw, rt, [a for a in iter(rt)]


def test_stream_runtime_matches_serial_exactly(streamed):
    raw, rt, got = streamed
    want = _serial_reference(raw)
    assert rt.blocks_processed == N_BLOCKS
    assert rt.stats["dropped_bytes"] == 0
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32 for a in got)
    np.testing.assert_array_equal(np.concatenate(got), want)


def test_stream_runtime_close_to_tpudsp_runtime(streamed):
    """>= 80 dB from the JAX package's runtime driving its AMReceiver with
    the Pallas back end (interpret mode on the CPU) on the same bytes, over
    the settled second half."""
    raw, _, got = streamed
    jrt = JStreamRuntime(jam.AMReceiver(jam.AMConfig(), block_len=BLOCK, backend="pallas"))
    jrt.push(raw)
    jrt.stop(drain=True)
    want = np.concatenate(list(jrt))
    got = np.concatenate(got)
    assert got.shape == want.shape
    half = len(want) // 2
    s = snr_db(want[half:], got[half:])
    assert s > 80.0, f"{s:.1f} dB"


def test_stream_runtime_on_audio_callback_and_metrics():
    raw = _am_bytes(2 * BLOCK)
    seen = []
    rt = StreamRuntime(_rx(), on_audio=lambda a, meta: seen.append((a, meta)))
    rt.push(raw)
    rt.stop(drain=True)
    assert [m["block"] for _, m in seen] == [0, 1]
    # the callback gets the audio on the receiver's device
    assert all(torch.is_tensor(a) and a.device.type == "cpu" for a, _ in seen)
    # the receiver exposes per-block metrics; the runtime forwards them
    assert seen[-1][1]["metrics"] is not None
    assert np.isfinite(float(seen[-1][1]["metrics"].rssi))
    with pytest.raises(RuntimeError):
        rt.pop_audio(timeout=0.01)


def test_stream_runtime_on_event_fires_squelch_transitions():
    """on_event gets every squelch rise and fall of a block's modes, with
    the block's index, as squelch_events finds them."""
    from tpudsp_torch.chains.metrics import BlockMetrics
    from tpudsp_torch.kernels.agc import SQ_FALL, SQ_RISE

    class Gated:
        block_len = 100
        metrics = None

        def __call__(self, iq):
            modes = torch.full((10,), 7, dtype=torch.int32)
            modes[3], modes[8] = SQ_RISE, SQ_FALL
            self.metrics = BlockMetrics(None, modes, None, None)
            return iq.real

    events = []
    rt = StreamRuntime(Gated(), sample_format="int16", on_event=events.append,
                       device="cpu")
    rt.push(b"\x00" * 800)
    rt.stop(drain=True)
    assert [(e["kind"], e["sample"], e["block"]) for e in events] == [
        ("rise", 3, 0), ("fall", 8, 0), ("rise", 3, 1), ("fall", 8, 1)]


def test_stream_runtime_partial_tail_block_discarded():
    raw = _am_bytes(BLOCK + BLOCK // 2)
    rt = StreamRuntime(_rx())
    rt.push(raw)
    rt.stop(drain=True)
    assert rt.blocks_processed == 1
    assert rt.stats["pending_bytes"] == (BLOCK // 2) * 4


def test_stream_runtime_surfaces_receiver_errors():
    def broken(_iq):
        raise ValueError("boom")

    rt = StreamRuntime(broken, block_len=BLOCK, device="cpu")
    rt.push(_am_bytes(BLOCK))
    with pytest.raises(ValueError, match="boom"):
        rt.stop(drain=True)


def test_stream_runtime_block_len_required_for_plain_callables():
    with pytest.raises(ValueError, match="block_len"):
        StreamRuntime(lambda iq: iq)


def test_stream_runtime_plain_callable_on_the_card_by_default():
    """With no device, a plain callable's runtime runs on "cuda": on a
    machine without a card, building it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        StreamRuntime(lambda iq: iq, block_len=BLOCK)


def test_stream_runtime_stop_drain_does_not_deadlock_on_full_queue():
    # with more pending blocks than max_audio_blocks and a consumer that
    # only reads AFTER stop() returns (the documented pattern), the drain
    # bound is lifted, so all complete blocks must come through
    n_blocks = 5
    raw = _am_bytes(n_blocks * BLOCK)
    rt = StreamRuntime(_rx(), max_audio_blocks=1)
    rt.push(raw)
    rt.stop(drain=True)  # must return despite the size-1 audio queue
    got = [a for a in iter(rt)]
    assert len(got) == n_blocks
    assert rt.blocks_processed == n_blocks


def test_stream_runtime_push_after_stop_rejected():
    rt = StreamRuntime(_rx())
    rt.push(_am_bytes(BLOCK))
    rt.stop(drain=True)
    with pytest.raises(RuntimeError, match="stop"):
        rt.push(_am_bytes(BLOCK))


def test_stream_runtime_error_stays_visible():
    # a pump error must be observable by every caller, not swallowed by
    # whichever thread happened to poll first
    def broken(_iq):
        raise ValueError("boom")

    rt = StreamRuntime(broken, block_len=BLOCK, device="cpu")
    rt.push(_am_bytes(BLOCK))
    rt._pump.join(timeout=10)  # pump dies on the first block
    assert not rt._pump.is_alive()
    # the producer thread's push() observes the pump failure ...
    with pytest.raises(ValueError, match="boom"):
        rt.push(_am_bytes(BLOCK))
    # ... and so do stop() and pop_audio(), repeatedly
    with pytest.raises(ValueError, match="boom"):
        rt.stop(drain=True)
    with pytest.raises(ValueError, match="boom"):
        rt.pop_audio(timeout=0.01)


def test_stream_runtime_raw_i16_passthrough_matches_converted():
    """sample_format='int16_raw' + AMReceiver(input_format='i16'): the
    zero-host-conversion pipeline must produce the same audio as the
    converting path."""
    raw = _am_bytes(3 * BLOCK)
    rt_c = StreamRuntime(_rx())
    rt_c.push(raw)
    rt_c.stop(drain=True)
    want = np.concatenate(list(iter(rt_c)))

    rt_i = StreamRuntime(_rx(input_format="i16"), sample_format="int16_raw")
    rt_i.push(raw)
    rt_i.stop(drain=True)
    got = np.concatenate(list(iter(rt_i)))
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err < 1e-6 * max(1.0, np.abs(want).max()) + 1e-7, err


def test_stream_runtime_raw_u8_passthrough_matches_converted():
    """sample_format='uint8_raw' + AMReceiver(input_format='u8'): the
    RTL-SDR zero-host-conversion pipeline must match the converting
    'uint8' path (which feeds the c64 chain u8_to_iq samples)."""
    n = 3 * BLOCK
    t = np.arange(n)
    msg = np.sin(2 * np.pi * 1000.0 / 2e6 * t)
    iq = (1.0 + 0.5 * msg) * 0.3 * np.exp(2j * np.pi * 200.0 / 2e6 * t)
    xs = np.empty(2 * n, np.uint8)
    xs[0::2] = np.clip(np.round(iq.real * 127.5 * 0.9 + 127.5), 0, 255)
    xs[1::2] = np.clip(np.round(iq.imag * 127.5 * 0.9 + 127.5), 0, 255)
    raw = xs.tobytes()

    rt_c = StreamRuntime(_rx(), sample_format="uint8")
    rt_c.push(raw)
    rt_c.stop(drain=True)
    want = np.concatenate(list(iter(rt_c)))

    rt_u = StreamRuntime(_rx(input_format="u8"), sample_format="uint8_raw")
    rt_u.push(raw)
    rt_u.stop(drain=True)
    got = np.concatenate(list(iter(rt_u)))
    assert got.shape == want.shape
    # block 0 carries the documented half-LSB u8 tail-init transient
    w, g = want[300:], got[300:]
    err = np.abs(g - w).max()
    assert err < 1e-5 * max(1.0, np.abs(w).max()), err


def test_stream_runtime_stereo_wire_format():
    """WBFM stereo chain fed raw RTL-SDR bytes through the runtime
    ('uint8_raw' + input_format='u8'): (M, 2) PCM comes out and matches
    serial block calls on the same wire bytes exactly."""
    from tpudsp_torch.chains.wbfm import WBFMStereoReceiver

    n = 100_000
    fs = 2_400_000.0
    t = np.arange(2 * n)
    f_p = 19000.0 / fs
    comp = (np.sin(2 * np.pi * 700.0 / fs * t)
            + 0.1 * np.cos(2 * np.pi * f_p * t)) * 0.008
    x = np.exp(1j * 2 * np.pi * np.cumsum(comp) * 4.0).astype(np.complex64)
    wire = np.clip(np.round(np.stack([x.real, x.imag], axis=1)
                            * 127.5 + 127.5), 0, 255).astype(np.uint8)

    rx = WBFMStereoReceiver(block_len=n, input_format="u8", device="cpu")
    rt = StreamRuntime(rx, sample_format="uint8_raw")
    rt.push(wire.tobytes())
    rt.stop(drain=True)
    streamed = np.concatenate(list(rt), axis=0)

    rx2 = WBFMStereoReceiver(block_len=n, input_format="u8", device="cpu")
    serial = np.concatenate(
        [rx2(torch.from_numpy(wire[:n])).numpy(),
         rx2(torch.from_numpy(wire[n:])).numpy()], axis=0)
    assert streamed.shape == serial.shape
    assert streamed.shape[1] == 2
    assert np.array_equal(streamed, serial)


def test_stream_runtime_drain_pop_push_race_deterministic():
    """Regression: a ring read that STARTS before a concurrent push's write
    returns nothing; stop() then sets _stopping and the pump must NOT exit
    on that stale miss -- the drain barrier does one fresh pop after
    observing _stopping. Simulated deterministically: the first pop
    returns nothing regardless of ring content."""
    raw = _am_bytes(2 * BLOCK)
    seen = []
    rt = StreamRuntime(_rx(), on_audio=lambda a, meta: seen.append(meta["block"]))
    # pause the pump on a fence so the raced pop provably happens after
    # push: pop #1 waits for the push, then reports nothing (the race)
    pushed = threading.Event()
    real_pop = rt._stream.pop_into
    calls = []

    def raced_pop(buf):
        calls.append(None)
        if len(calls) == 1:
            pushed.wait(timeout=5.0)
            return False  # ring read raced the concurrent write
        return real_pop(buf)

    rt._stream.pop_into = raced_pop
    rt.push(raw)
    pushed.set()
    rt.stop(drain=True)
    assert seen == [0, 1], f"drain dropped blocks: {seen}"


def test_stream_runtime_drain_under_load():
    """Probabilistic twin of the deterministic race test: tight
    push-then-stop iterations under scheduler pressure, the interpreter's
    switch interval cut to 20 us so threads switch more often around the
    race. The receiver is the block's envelope: each op of the AM
    receiver's plain versions (its CPU form) drops and retakes the
    interpreter lock, so behind four burner threads its 60 blocks take
    many minutes, while the JAX package's receiver returns after its
    dispatch, as this one does."""
    raw = _am_bytes(2 * BLOCK)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(2e-5)
    stop_burn = threading.Event()

    def burner():
        x = 1.0
        while not stop_burn.is_set():
            x = x * 1.0000001 + 1e-9

    burners = [threading.Thread(target=burner, daemon=True)
               for _ in range(4)]
    for b in burners:
        b.start()
    try:
        for i in range(30):
            seen = []
            rt = StreamRuntime(torch.abs, block_len=BLOCK, device="cpu",
                               on_audio=lambda a, m: seen.append(m["block"]))
            rt.push(raw)
            rt.stop(drain=True)
            assert seen == [0, 1], f"iter {i}: drain dropped blocks {seen}"
    finally:
        stop_burn.set()
        sys.setswitchinterval(interval)
        for b in burners:
            b.join(timeout=10)
