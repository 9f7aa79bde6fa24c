"""The port's IO layer (tpudsp_torch.io) against the JAX package's
(tpudsp.io) on the same numpy-seeded bytes: the native conversions bit for
bit, the device-side ``frame`` bit for bit with them, IQStream's framing,
overflow and threaded producer (mirrors of tests/test_io.py) with every
``sample_format``'s blocks bit-equal to tpudsp's IQStream, the native
library built into tpudsp_torch/_build/, and the WAV files byte-identical
to tpudsp's, from numpy and from CPU tensors."""

import os
import threading
import time
import wave

import numpy as np
import pytest
import torch

from tpudsp import io as jio
from tpudsp.io import ingest as jingest
from tpudsp_torch import io as tio
from tpudsp_torch.io import IQStream, WavSink, bytes_to_iq, u8_to_iq, write_wav
from tpudsp_torch.io import ingest as tingest

FORMATS = ("int16", "uint8", "int16_raw", "uint8_raw")


@pytest.fixture(scope="module", autouse=True)
def tpudsp_native():
    """The JAX package's native library, loaded before its bits are held
    against the port's: tpudsp builds it beside its source at first use,
    and a test process that loads it while another is still writing it
    takes tpudsp's NumPy fallback for good; retry until it loads."""
    for _ in range(100):
        if jingest._load():
            return
        jingest._lib = None
        time.sleep(0.1)
    pytest.fail("tpudsp's native ingest library did not load")


def _wire(n_bytes: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.complex64 else a


def test_native_library_builds_into_the_port_build_dir():
    """The port loads its own copy of ingest.cpp, built by g++ into
    tpudsp_torch/_build/, never beside the source; this process leaves no
    temporary file (another test process may be building at this time)."""
    assert tingest._load(), "g++ could not build io/native/ingest.cpp"
    assert tingest._SO.parent.name == "_build" and tingest._SO.parent.parent.name == "tpudsp_torch"
    assert tingest._SO.exists()
    assert not list(tingest._SRC.parent.glob("*.so"))
    assert not tingest._SO.with_suffix(f".{os.getpid()}.tmp").exists()


def test_bytes_to_iq_matches_reference_semantics():
    raw = np.array([32767, 0, 0, -32767, 16384, -16384, 123, 456],
                   dtype=np.int16).tobytes()
    iq = bytes_to_iq(raw)
    assert iq.dtype == np.complex64
    ref = np.array([1.0, -1.0j, 0.5 - 0.5j, (123 + 456j) / 32767.0],
                   dtype=np.complex64)
    np.testing.assert_allclose(iq, ref, atol=1e-4)
    assert len(bytes_to_iq(raw + b"\x00")) == 4  # partial pair dropped


def test_u8_to_iq():
    raw = bytes([255, 0, 127, 128])
    iq = u8_to_iq(raw)
    np.testing.assert_allclose(iq.real, [1.0, -0.0039216], atol=1e-3)
    np.testing.assert_allclose(iq.imag, [-1.0, 0.0039216], atol=1e-3)


@pytest.mark.parametrize("tail", [0, 1, 3])
def test_conversions_bit_equal_to_tpudsp(tail):
    """Every int16 and uint8 value, and random bytes with a ragged tail,
    convert to the JAX package's native bits."""
    every16 = np.arange(-32768, 32768, dtype=np.int16).tobytes()
    every8 = np.arange(256, dtype=np.uint8).repeat(2).tobytes()
    for raw in (every16, _wire(40_000, 1)):
        raw = raw + b"\x07" * tail
        np.testing.assert_array_equal(_bits(bytes_to_iq(raw)), _bits(jio.bytes_to_iq(raw)))
    for raw in (every8, _wire(40_000, 2)):
        raw = raw + b"\x07" * tail
        np.testing.assert_array_equal(_bits(u8_to_iq(raw)), _bits(jio.u8_to_iq(raw)))


def test_ops_bytes_to_iq_is_the_native_conversion():
    """ops.util.bytes_to_iq delegates to io.ingest: one conversion."""
    from tpudsp_torch.ops.util import bytes_to_iq as op_bytes_to_iq
    raw = _wire(20_002, 3)
    np.testing.assert_array_equal(_bits(op_bytes_to_iq(raw)), _bits(bytes_to_iq(raw)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_frame_bit_equal_to_the_native_conversion(fmt):
    """The runtime's device-side framing (here on CPU tensors) gives the
    bits of IQStream.pop_block's host conversion."""
    raw = np.frombuffer(_wire(4 * 5000, 4), np.uint8).copy()
    s = IQStream(block_len=5000 if fmt.startswith("int16") else 10_000, sample_format=fmt)
    s.push(raw.tobytes())
    want = s.pop_block()
    got = tingest.frame(torch.from_numpy(raw), fmt).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_iqstream_block_framing():
    s = IQStream(block_len=100, capacity_blocks=4)
    assert s.pop_block() is None
    data = np.arange(250 * 2, dtype=np.int16).tobytes()  # 250 IQ pairs
    s.push(data)
    b1 = s.pop_block()
    b2 = s.pop_block()
    assert b1 is not None and b2 is not None and s.pop_block() is None
    full = bytes_to_iq(data)
    np.testing.assert_array_equal(b1, full[:100])
    np.testing.assert_array_equal(b2, full[100:200])
    assert s.pending_bytes == 50 * 4


def test_iqstream_overflow_drops_whole_writes():
    s = IQStream(block_len=10, capacity_blocks=2)
    blk = b"\x00" * (10 * 4)
    wrote = sum(s.push(blk) for _ in range(5))
    assert wrote <= 2 * 10 * 4 + 10 * 4  # capacity rounded up to pow2
    assert s.dropped > 0


def test_iqstream_threaded_producer():
    s = IQStream(block_len=256, capacity_blocks=32)
    n_blocks = 64
    payload = np.random.default_rng(0).integers(
        -1000, 1000, size=n_blocks * 256 * 2, dtype=np.int16).tobytes()

    def producer():
        step = 256 * 4
        for i in range(0, len(payload), step):
            while s.push(payload[i:i + step]) == 0:
                pass

    th = threading.Thread(target=producer)
    th.start()
    got = []
    while len(got) < n_blocks:
        b = s.pop_block()
        if b is not None:
            got.append(b)
    th.join(timeout=30)
    assert not th.is_alive()
    np.testing.assert_array_equal(np.concatenate(got), bytes_to_iq(payload))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_iqstream_blocks_bit_equal_to_tpudsp(fmt, native, monkeypatch):
    """The same odd-sized pushes into the port's and tpudsp's IQStream pop
    the same blocks, bit for bit, as writable arrays (torch.as_tensor
    warns on read-only ones), and drop the same overflowing writes; the
    port's NumPy fallback (a host without g++) against tpudsp's."""
    if not native:
        monkeypatch.setattr(tingest, "_lib", False)
        monkeypatch.setattr(jingest, "_lib", False)
    block = 3000
    bps = 2 if fmt.startswith("uint8") else 4
    wire = _wire(7 * block * bps + 123, 5)
    t = IQStream(block, capacity_blocks=4, sample_format=fmt)
    j = jio.IQStream(block, capacity_blocks=4, sample_format=fmt)
    assert t._native == native
    step = 7777
    ours, theirs = [], []
    for i in range(0, len(wire), step):
        assert t.push(wire[i:i + step]) == j.push(wire[i:i + step])
        if i % (3 * step) == 0:
            for s, out in ((t, ours), (j, theirs)):
                b = s.pop_block()
                if b is not None:
                    out.append(b)
    for s, out in ((t, ours), (j, theirs)):
        while (b := s.pop_block()) is not None:
            out.append(b)
    assert len(ours) == len(theirs) >= 3
    for a, b in zip(ours, theirs):
        assert a.flags.writeable and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert (t.dropped, t.pending_bytes) == (j.dropped, j.pending_bytes)


def test_pop_into_rejects_a_wrong_buffer():
    s = IQStream(block_len=100, sample_format="uint8_raw")
    with pytest.raises(ValueError, match="200 bytes"):
        s.pop_into(np.empty(100, np.uint8))
    with pytest.raises(ValueError, match="200 bytes"):
        s.pop_into(np.empty(200, np.int8))


def test_write_wav_roundtrip_mono_and_stereo(tmp_path):
    rate = 48_000
    t = np.arange(4800, dtype=np.float32)
    mono = (0.5 * np.sin(2 * np.pi * 440 / rate * t)).astype(np.float32)
    p = str(tmp_path / "m.wav")
    write_wav(p, mono, rate)
    with wave.open(p) as w:
        assert (w.getnchannels(), w.getframerate(), w.getsampwidth()) == (1, rate, 2)
        back = np.frombuffer(w.readframes(w.getnframes()), "<i2") / 32767.0
    np.testing.assert_allclose(back, mono, atol=1 / 32767)

    stereo = np.stack([mono, -mono], axis=1)  # FMStereo-style (N, 2)
    p2 = str(tmp_path / "s.wav")
    write_wav(p2, stereo, rate)
    with wave.open(p2) as w:
        assert w.getnchannels() == 2
        back = np.frombuffer(w.readframes(w.getnframes()), "<i2"
                             ).reshape(-1, 2) / 32767.0
    np.testing.assert_allclose(back, stereo, atol=1 / 32767)


def test_wav_sink_streaming_matches_one_shot(tmp_path):
    rate = 48_000
    rng = np.random.default_rng(1)
    pcm = (rng.standard_normal(10_000) * 0.2).astype(np.float32)
    p1, p2 = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(p1, pcm, rate)
    with WavSink(p2, rate) as sink:
        for i in range(0, len(pcm), 1337):
            sink(pcm[i:i + 1337])
    assert sink.frames_written == len(pcm)
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_wav_sink_infers_stereo_and_validates_channels(tmp_path):
    rate = 48_000
    t = np.arange(4800, dtype=np.float32)
    mono = (0.4 * np.sin(2 * np.pi * 440 / rate * t)).astype(np.float32)
    stereo = np.stack([mono, -mono], axis=1)

    p = str(tmp_path / "s.wav")
    with WavSink(p, rate) as sink:  # channels inferred from first block
        sink(stereo[:1000])
        sink(stereo[1000:])
    assert sink.frames_written == len(stereo)
    with wave.open(p) as w:
        assert w.getnchannels() == 2
        back = np.frombuffer(w.readframes(w.getnframes()), "<i2"
                             ).reshape(-1, 2) / 32767.0
    np.testing.assert_allclose(back, stereo, atol=1 / 32767)

    # explicit channel count disagreeing with the data is an error
    with WavSink(str(tmp_path / "bad.wav"), rate, channels=1) as sink:
        with pytest.raises(ValueError, match="channel"):
            sink(stereo)
    # channel count changing mid-stream is an error
    with WavSink(str(tmp_path / "bad2.wav"), rate) as sink:
        sink(stereo[:10])
        with pytest.raises(ValueError, match="channel"):
            sink(mono[:10])
    # a sink that never saw a block still closes to a valid empty file
    with WavSink(str(tmp_path / "empty.wav"), rate):
        pass
    with wave.open(str(tmp_path / "empty.wav")) as w:
        assert w.getnframes() == 0


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_files_byte_identical_to_tpudsp(tmp_path, channels, as_tensor):
    """write_wav and a streaming WavSink write the bytes of tpudsp's, from
    numpy and from CPU tensors; PCM beyond [-1, 1] is clipped alike."""
    rng = np.random.default_rng(7)
    pcm = (rng.standard_normal((9001, channels)) * 0.6).astype(np.float32)
    pcm = pcm[:, 0] if channels == 1 else pcm
    ours = torch.from_numpy(pcm) if as_tensor else pcm
    paths = {k: str(tmp_path / f"{k}.wav") for k in ("t1", "j1", "t2", "j2")}
    write_wav(paths["t1"], ours, 48_000)
    jio.write_wav(paths["j1"], pcm, 48_000)
    with WavSink(paths["t2"], 48_000) as ts, jio.WavSink(paths["j2"], 48_000) as js:
        for i in range(0, len(pcm), 2000):
            ts(ours[i:i + 2000], {"block": i})
            js(pcm[i:i + 2000], {"block": i})
    assert ts.frames_written == js.frames_written == len(pcm)
    for a, b in (("t1", "j1"), ("t2", "j2"), ("t1", "t2")):
        assert open(paths[a], "rb").read() == open(paths[b], "rb").read()


def test_io_all_matches_tpudsp():
    assert tio.__all__ == jio.__all__
