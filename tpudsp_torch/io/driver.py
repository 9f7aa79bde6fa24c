"""Driver-shaped streaming source: bridge callback-style SDR drivers
into a StreamRuntime (port of ``tpudsp/io/driver.py``: pure host code,
the same classes; with the same ``render`` and ``seed`` the mock's wire
bytes equal the JAX package's).

The reference's whole deployment story is a radio-driver callback loop
(reference README.md:41-64: ``radio.onIQData = AMRadio();
radio.running = True`` with sdrplay, and the same shape for rtlsdr /
SoapySDR). ``RadioSource`` is that boundary as a component: it IS the
callback — hand it to whichever driver style is in use — and it feeds
the runtime's byte ring with real backpressure semantics (a full ring
drops whole callbacks, counted, never torn).

Two driver shapes are supported:

- rtlsdr/pyrtlsdr style (blocking async read loop)::

      rt = StreamRuntime(bank, sample_format="uint8_raw")
      src = RadioSource(rt)
      src.run_async(sdr, chunk_bytes=262144)   # sdr.read_bytes_async on a thread
      ...
      src.stop()

- sdrplay/SoapySDR assignment style (driver owns the thread)::

      radio.onIQData = src     # src is callable: src(bytes_or_ndarray)
      radio.running = True

Real drivers deliver variable-size chunks, overflow under load, and
drift against nominal rate; ``MockRTLSDRDriver`` reproduces all three
for tests and examples (tests/test_torch_driver_source.py pins the runtime's
behavior under each).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from .stream import StreamRuntime


class RadioSource:
    """The driver-facing callback for a StreamRuntime.

    runtime: a running StreamRuntime whose ``sample_format`` matches the
    driver's wire format ('uint8_raw' for RTL-SDR byte streams,
    'int16'/'int16_raw' for 16-bit front ends).

    Calling the source with a chunk (bytes, bytearray, memoryview, or a
    numpy array of the wire dtype) pushes it into the runtime's ring.
    Overflow is absorbed here exactly as a real-time front end must:
    the whole chunk is dropped (never torn mid-sample) and counted in
    ``overflow_chunks``/``overflow_bytes`` — the driver thread is never
    blocked.
    """

    def __init__(self, runtime: StreamRuntime):
        self.runtime = runtime
        self.chunks_delivered = 0
        self.bytes_delivered = 0
        self.overflow_chunks = 0
        self.overflow_bytes = 0
        self.error: Optional[BaseException] = None
        self._driver = None
        self._thread: Optional[threading.Thread] = None

    # -- the driver callback (both driver styles call this) ----------------

    def __call__(self, data, context=None) -> int:
        """Driver callback: push one chunk. Returns bytes accepted
        (0 = ring full, whole chunk dropped)."""
        if isinstance(data, np.ndarray):
            b = data.tobytes()
        elif isinstance(data, (bytes, bytearray, memoryview)):
            b = bytes(data)
        else:
            raise TypeError(f"driver chunk must be bytes-like or ndarray, "
                            f"got {type(data).__name__}")
        self.chunks_delivered += 1
        self.bytes_delivered += len(b)
        try:
            got = self.runtime.push(b)
        except BaseException as e:
            # a driver's C callback context must never see an exception:
            # absorb (runtime stopped / pump failed), count the chunk as
            # dropped, surface the error via .error / stop()
            self.error = e
            got = 0
        if got == 0 and len(b):
            self.overflow_chunks += 1
            self.overflow_bytes += len(b)
        return got

    # -- rtlsdr-style blocking read loop, moved to its own thread ----------

    def run_async(self, driver, chunk_bytes: int = 262144) -> None:
        """Start ``driver.read_bytes_async(self, chunk_bytes)`` on a
        dedicated thread (pyrtlsdr's read loop blocks its caller).
        ``stop()`` cancels it via ``driver.cancel_read_async()``."""
        if self._thread is not None:
            raise RuntimeError("run_async() already active")
        self._driver = driver
        self._thread = threading.Thread(
            target=driver.read_bytes_async, args=(self, chunk_bytes),
            name="tpudsp-driver", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Cancel the driver loop (if attached) and stop the runtime."""
        if self._driver is not None:
            self._driver.cancel_read_async()
            self._thread.join()
            self._driver = None
            self._thread = None
        self.runtime.stop(drain=drain)

    @property
    def stats(self) -> dict:
        s = dict(self.runtime.stats)
        s.update(chunks_delivered=self.chunks_delivered,
                 bytes_delivered=self.bytes_delivered,
                 overflow_chunks=self.overflow_chunks,
                 overflow_bytes=self.overflow_bytes,
                 error=None if self.error is None else repr(self.error))
        return s


class MockRTLSDRDriver:
    """A pyrtlsdr-shaped mock driver for tests and examples.

    Synthesizes an RTL-SDR uint8 wire stream from ``render`` and
    delivers it through ``read_bytes_async(callback, chunk_bytes)``
    exactly the way the real driver does — from a blocking loop, in
    chunks, until ``cancel_read_async()``. Three real-driver behaviors
    are reproducible on demand:

    - variable-size callbacks: ``variable=True`` jitters each chunk's
      size (sample-aligned — real drivers never split a sample);
    - overflow: ``burst_chunks=k`` delivers the first k chunks
      back-to-back with no pacing, overrunning any bounded ring;
    - sample-rate drift: ``drift_ppm`` stretches the rendered timebase,
      as a real crystal does against nominal ``sample_rate``.

    render(n0, n) -> complex IQ array (values in [-1, 1]) for absolute
    sample indices [n0, n0+n); the mock quantizes to the u8 wire format
    ((v*127.5 + 127.5) clipped, interleaved I,Q).
    """

    def __init__(self, render: Callable[[int, int], np.ndarray],
                 total_samples: int, sample_rate: float = 2_400_000.0,
                 center_freq: float = 100e6, gain: float = 40.0,
                 variable: bool = True, drift_ppm: float = 0.0,
                 burst_chunks: int = 0, seed: int = 0):
        self.render = render
        self.total_samples = int(total_samples)
        self.sample_rate = float(sample_rate)   # nominal, as reported
        self.center_freq = float(center_freq)
        self.gain = float(gain)
        self.variable = bool(variable)
        self.drift = 1.0 + drift_ppm * 1e-6     # true rate / nominal
        self.burst_chunks = int(burst_chunks)
        self._rng = np.random.default_rng(seed)
        self._cancel = threading.Event()

    def _wire(self, n0: int, n: int) -> bytes:
        # drift: the crystal's true tick maps wire index k to signal
        # time k*drift (rendered on the stretched timebase)
        idx0 = int(round(n0 * self.drift))
        nn = int(round((n0 + n) * self.drift)) - idx0
        v = np.asarray(self.render(idx0, max(nn, 1)))[:n]
        if len(v) < n:  # drift < 1: repeat-last pad to keep chunk size
            v = np.concatenate([v, np.repeat(v[-1:], n - len(v))])
        w = np.empty(2 * n, np.uint8)
        w[0::2] = np.clip(np.round(v.real * 127.5 + 127.5), 0, 255)
        w[1::2] = np.clip(np.round(v.imag * 127.5 + 127.5), 0, 255)
        return w.tobytes()

    def read_bytes_async(self, callback, num_bytes: int = 262144) -> None:
        """Blocking delivery loop (run it on a thread, as pyrtlsdr users
        do): calls ``callback(bytes, self)`` until the stream is
        exhausted or cancel_read_async()."""
        self._cancel.clear()
        chunk = max(num_bytes // 2, 1)  # samples per chunk
        n0 = 0
        k = 0
        while n0 < self.total_samples and not self._cancel.is_set():
            n = chunk
            if self.variable:
                n = int(chunk * self._rng.uniform(0.5, 1.5))
            n = max(min(n, self.total_samples - n0), 1)
            callback(self._wire(n0, n), self)
            n0 += n
            k += 1
            if k > self.burst_chunks:
                # paced like a real front end: sleep the chunk's air time
                # (scaled down 50x so tests run fast but order/backpressure
                # semantics are preserved)
                self._cancel.wait(n / self.sample_rate / 50.0)

    def cancel_read_async(self) -> None:
        self._cancel.set()
