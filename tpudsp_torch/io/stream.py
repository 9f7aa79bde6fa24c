"""Streaming executor (port of ``tpudsp/io/stream.py``): drive any
receiver chain from raw radio bytes.

The reference leaves the real-time plumbing to user code -- its README
pattern (reference README.md:53-58) is a radio-driver callback that calls
the chain synchronously per block, so conversion, DSP and audio handling
all serialize on one thread. Here that loop is a runtime component:

    radio thread --push(bytes)--> native SPSC ring (io/native/ingest.cpp)
                                        | pump thread, on the runtime's
                                        | own CUDA stream s
                                        v
        ring read into a pinned host slot --> one non_blocking copy to the
        card --> io.ingest.frame (int16 / u8 -> c64 on the card for the
        converting formats) --> receiver(block)
                                        |
                                        v
        on_audio(audio, meta) on the pump thread with s current, or a
        non_blocking copy into pinned memory --> audio queue --> pop_audio()

Overlap. Calling a receiver only enqueues its kernels on s, and nothing
the pump does per block waits for the card but two hand-overs: a pinned
slot is refilled only once the copy out of it (an event) has completed,
so with ``SLOTS`` slots the pump frames up to that many blocks ahead of
the card; and audio for the queue is handed over once its copy's event
has completed -- at most one block's audio waits, so the queue sees block
k's audio while block k+1 is being framed and enqueued. So the ring read
of block k+1 overlaps the card's work on block k, as in the JAX package;
audio comes out in push order with the same content, and may appear a
block later than the JAX package's. A pump with nothing to frame waits
for all pending audio.

Streams. The pump runs the receiver under ``torch.cuda.stream(s)``; s
waits on the constructing thread's current stream before the first block
(the receiver was built there), and ``stop()`` makes the caller's current
stream wait on s, so ``receiver.state`` can be read or checkpointed right
after it. ``on_audio`` and ``on_event`` run with s current, so a callback
that reads a tensor (``float(metrics.rssi)``, a WavSink) reads it after
its block's kernels. One thread enqueues on s: the blocked scans' launch
bookkeeping (``cuda/launch.chain``) is per stream and needs that. Backpressure
is physical: if the consumer falls behind, the audio queue fills, the pump
stalls, the ring fills, and the ring drops whole writes (counted, never
torn) -- exactly what a real-time SDR front end must do.

Determinism: blocks flow through the receiver in push order on one pump
thread, so the carried-state evolution -- and therefore the audio -- is
identical to calling ``receiver(block)`` serially (pinned by
tests/test_torch_stream_runtime.py and chip_smoke.py's stream phase).
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..kernels.lanes import tree_map
from ..ops.base import to_numpy
from .ingest import IQStream, frame

SLOTS = 2   # pinned host slots the ring reads into, on a CUDA device

# (device, stream handle) of every live runtime: torch hands out streams
# from a pool of 32 per device, and two pumps must never share one
_live: set = set()
_live_lock = threading.Lock()


def _own_stream(device: torch.device) -> torch.cuda.Stream:
    """A stream from torch's pool that no live runtime holds."""
    with _live_lock:
        for _ in range(64):
            s = torch.cuda.Stream(device)
            if (device, s.cuda_stream) not in _live:
                _live.add((device, s.cuda_stream))
                return s
    raise RuntimeError(f"no free CUDA stream on {device}: too many StreamRuntimes at once")


class StreamRuntime:
    """Run a receiver chain as a streaming service.

    receiver: any stateful chain callable ``receiver(iq_block) -> audio``
        over fixed-size blocks (AMReceiver, ReceiverBank,
        WBFMStereoReceiver, ChannelizedBank, ..., or a compat-API
        composition wrapped in a function). ``block_len`` is taken from
        ``receiver.block_len`` unless given.
    sample_format: 'int16' (1/32767 scaling, reference utility.hpp:61-69),
        'uint8' (RTL-SDR style), or the raw passthrough twins
        'int16_raw' / 'uint8_raw' (the receiver gets the (N, 2) wire
        samples -- pair with a chain built with input_format='i16' / 'u8'
        for 2-4x less host->device and device-memory traffic). The
        converting formats convert on the device (``io.ingest.frame``),
        bit for bit as the native conversion.
    on_audio: optional callback ``on_audio(audio, meta)`` invoked on the
        pump thread per block, with the audio on the device and the
        runtime's stream current (meta carries the block index and the
        receiver's per-block metrics when it exposes ``.metrics``). When
        None, audio is buffered in a bounded queue for ``pop_audio()``.
    on_event: optional callback ``on_event(event)`` fired on the pump
        thread after each block for every squelch transition found in the
        block's ``metrics.squelch_modes`` tensor -- the reference's AGC
        ``onRise`` mid-loop callback (agc.hpp:119-122) delivered the
        events-become-data way (SURVEY section 3.5). Each event is a dict
        with ``kind`` ('rise'/'fall'), ``channel`` (None for
        single-channel chains), ``sample`` (offset within the block at the
        tensor's rate), and ``block``. Registering on_event syncs the mode
        tensor to host each block; leave it None on throughput-critical
        paths.
    capacity_blocks: ring capacity; overflow drops whole pushes (counted).
    max_audio_blocks: audio-queue bound; the pump blocks when full
        (backpressure into the ring).
    device: where a plain callable's blocks go (default "cuda"); a
        receiver with a ``.device`` (every chain of the port) runs on its
        own.
    """

    def __init__(self, receiver: Callable[[Any], Any],
                 block_len: Optional[int] = None,
                 sample_format: str = "int16",
                 on_audio: Optional[Callable[[Any, dict], None]] = None,
                 on_event: Optional[Callable[[dict], None]] = None,
                 capacity_blocks: int = 64,
                 max_audio_blocks: int = 256, *, device="cuda"):
        if block_len is None:
            block_len = getattr(receiver, "block_len", None)
            if block_len is None:
                raise ValueError(
                    "receiver has no .block_len; pass block_len explicitly")
        self.receiver = receiver
        self.block_len = int(block_len)
        self.device = torch.device(getattr(receiver, "device", None) or device)
        self._stream = IQStream(self.block_len,
                                capacity_blocks=capacity_blocks,
                                sample_format=sample_format)
        self._format = sample_format
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._s = _own_stream(self.device)
            # the receiver (its state, its parameters) was built on the
            # caller's stream; its old state is freed on the pump's
            self._s.wait_stream(torch.cuda.current_stream(self.device))
            tree_map(lambda t: t.record_stream(self._s) if torch.is_tensor(t) else None,
                     getattr(receiver, "state", None))
            # [pinned bytes, their numpy view, the event of the last copy out]
            self._slots = [[h, h.numpy(), None] for h in (
                torch.empty(self._stream.block_bytes, dtype=torch.uint8, pin_memory=True)
                for _ in range(SLOTS))]
            self._framed = 0
        self._pending: collections.deque = collections.deque()
        self._on_audio = on_audio
        self._on_event = on_event
        self._audio: "queue.Queue" = queue.Queue(maxsize=max_audio_blocks)
        self._data = threading.Event()    # bytes arrived / stop requested
        self._stopping = False
        self._drain = True
        self._error: Optional[BaseException] = None
        self.blocks_processed = 0
        self._pump = threading.Thread(target=self._run, name="tpudsp-pump",
                                      daemon=True)
        self._pump.start()

    # -- producer side (radio-driver thread) --------------------------------

    def push(self, byts: bytes) -> int:
        """Feed raw IQ bytes; returns bytes accepted (0 = dropped whole)."""
        self._raise_if_failed()
        if self._stopping:
            raise RuntimeError("push() after stop(): runtime is stopped")
        n = self._stream.push(byts)
        self._data.set()
        return n

    # -- consumer side -------------------------------------------------------

    def pop_audio(self, timeout: Optional[float] = None):
        """Next audio block as np.ndarray, or None on timeout/end of
        stream. Only valid without an on_audio callback."""
        if self._on_audio is not None:
            raise RuntimeError("audio is routed to on_audio callback")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._raise_if_failed()
            wait = 0.1
            if deadline is not None:
                wait = min(wait, deadline - time.monotonic())
                if wait <= 0:
                    return None
            try:
                item = self._audio.get(timeout=wait)
            except queue.Empty:
                if self._stopping and not self._pump.is_alive():
                    return None
                continue
            return item

    def __iter__(self):
        while True:
            a = self.pop_audio()
            if a is None:
                return
            yield a

    def stop(self, drain: bool = True) -> None:
        """Stop the pump. drain=True first processes every complete block
        already in the ring (a partial tail block is discarded, as in the
        reference's fixed-size callback framing). On return the caller's
        current stream has waited on the runtime's.

        While draining, the audio-queue bound is lifted so stop() cannot
        deadlock against a consumer that only starts reading after stop()
        returns (the documented consume-after-stop pattern). The extra
        memory is bounded: at most ``capacity_blocks`` ring blocks remain
        to drain.
        """
        self._drain = drain
        self._stopping = True
        if drain:
            # queue.Queue re-checks maxsize under its mutex on every put;
            # 0 means unbounded, so a pump blocked in put() proceeds on
            # its next timed retry instead of deadlocking against join().
            with self._audio.mutex:
                self._audio.maxsize = 0
                self._audio.not_full.notify_all()
        self._data.set()
        self._pump.join()
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_stream(self._s)
        self._raise_if_failed()

    @property
    def stats(self) -> dict:
        return {
            "blocks_processed": self.blocks_processed,
            "dropped_bytes": self._stream.dropped,
            "pending_bytes": self._stream.pending_bytes,
            "audio_backlog": self._audio.qsize(),
        }

    # -- pump ----------------------------------------------------------------

    def _raise_if_failed(self):
        # _error stays set once the pump fails: every thread that touches
        # the runtime afterwards (producer push, consumer pop, stop) sees
        # the same failure instead of only the first caller.
        if self._error is not None:
            self._stopping = True
            raise self._error

    def _fire_events(self, meta: dict) -> None:
        from ..chains.metrics import squelch_events
        metrics = meta["metrics"]
        modes = getattr(metrics, "squelch_modes", None)
        if modes is None:
            return
        for ev in squelch_events(modes):  # host sync: opt-in via on_event
            ev["block"] = meta["block"]
            self._on_event(ev)

    def _next_block(self):
        """The next block on the device as the receiver takes it, or None
        when the ring holds less than a block."""
        if not self._cuda:
            raw = np.empty(self._stream.block_bytes, np.uint8)
            if not self._stream.pop_into(raw):
                return None
            return frame(torch.from_numpy(raw), self._format)
        slot = self._slots[self._framed % SLOTS]
        if slot[2] is not None:
            slot[2].synchronize()   # the slot's last copy out has completed
        if not self._stream.pop_into(slot[1]):
            return None
        raw = slot[0].to(self.device, non_blocking=True)
        slot[2] = torch.cuda.Event()
        slot[2].record()
        self._framed += 1
        return frame(raw, self._format)

    def _put(self, out) -> bool:
        """Bounded put that can still honor stop(drain=False): False when
        the runtime is abandoning its audio."""
        while True:
            try:
                self._audio.put(out, timeout=0.1)
                return True
            except queue.Full:
                if self._stopping and not self._drain:
                    return False

    def _hand_over(self, wait: bool) -> bool:
        """Put the pending audio whose copy has completed on the queue, in
        order, waiting for all of it (``wait``) or all but the newest block's."""
        while self._pending and (wait or len(self._pending) > 1
                                 or self._pending[0][0] is None or self._pending[0][0].query()):
            copied, host = self._pending.popleft()
            if copied is not None:
                copied.synchronize()
                host = host.numpy()
            if not self._put(host):
                return False
        return True

    def _queue_audio(self, audio) -> None:
        if not (torch.is_tensor(audio) and audio.is_cuda):
            self._pending.append((None, to_numpy(audio)))
            return
        host = torch.empty(audio.shape, dtype=audio.dtype, pin_memory=True)
        host.copy_(audio, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        self._pending.append((copied, host))

    def _run(self):
        try:
            with contextlib.ExitStack() as on:
                if self._cuda:
                    on.enter_context(torch.cuda.device(self.device))
                    on.enter_context(torch.cuda.stream(self._s))
                    on.callback(self._release_stream)
                self._pump_blocks()
        except BaseException as e:  # surfaced on the caller's next call
            self._error = e

    def _release_stream(self):
        with _live_lock:
            _live.discard((self.device, self._s.cuda_stream))

    def _pump_blocks(self):
        while True:
            iq = self._next_block()
            if iq is None:
                if not self._hand_over(wait=True):
                    return
                if self._stopping:
                    if not self._drain:
                        return
                    # Drain barrier (measured race, JAX package round 5):
                    # that pop's ring read can START before a concurrent
                    # push()'s ring write and return None, after which
                    # stop() sets _stopping -- exiting here would strand
                    # complete blocks in the ring with no error. Once
                    # _stopping is OBSERVED, every push that returned
                    # before stop() was called is visible in the ring
                    # (push happens-before stop in the producer, _stopping
                    # publication synchronizes with this read), so one
                    # fresh pop decides: None now really means drained.
                    iq = self._next_block()
                    if iq is None:
                        return
                else:
                    self._data.wait(timeout=0.05)
                    self._data.clear()
                    continue
            if self._stopping and not self._drain:
                return
            audio = self.receiver(iq)  # enqueues the block's kernels on s
            meta = {"block": self.blocks_processed,
                    "metrics": getattr(self.receiver, "metrics", None)}
            self.blocks_processed += 1
            if self._on_event is not None:
                self._fire_events(meta)
            if self._on_audio is not None:
                self._on_audio(audio, meta)
                continue
            self._queue_audio(audio)
            if not self._hand_over(wait=False):
                return
