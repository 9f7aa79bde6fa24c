"""WAV audio sinks for receiver output (port of ``tpudsp/io/wav.py``).

The reference emits raw float32 PCM and leaves playback plumbing to the
user (its README pipes the array to a sound device). These helpers land
float32 chain output in a standard playable container — one-shot
(`write_wav`) or streaming (`WavSink`, usable as a StreamRuntime
``on_audio`` callback). Pure stdlib (`wave`), host-side. PCM may be a
numpy array or a tensor on any device: a tensor comes to the host through
``ops.base.to_numpy`` (``np.asarray`` of a CUDA tensor raises).
"""

from __future__ import annotations

import wave

import numpy as np

from ..ops.base import to_numpy


def _to_int16(pcm: np.ndarray) -> np.ndarray:
    if pcm.dtype.kind != "f":
        raise TypeError(f"expected float PCM, got {pcm.dtype}")
    return np.round(np.clip(pcm, -1.0, 1.0) * 32767.0).astype("<i2")


def write_wav(path: str, pcm, rate: int) -> None:
    """Write float32 PCM in [-1, 1] as 16-bit WAV. Accepts (N,) mono or
    (N, C) multi-channel (e.g. FMStereo's (N, 2))."""
    pcm = to_numpy(pcm)
    nch = 1 if pcm.ndim == 1 else pcm.shape[1]
    with wave.open(path, "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(2)
        w.setframerate(int(rate))
        w.writeframes(_to_int16(pcm).tobytes())


class WavSink:
    """Streaming WAV writer: ``sink = WavSink(path, rate); sink(pcm)`` per
    block; close() finalizes the header. Signature doubles as a
    StreamRuntime ``on_audio=sink`` callback (extra args ignored)."""

    def __init__(self, path: str, rate: int, channels: int | None = None):
        """channels=None (default) infers the channel count from the first
        block's shape, like ``write_wav`` — so FMStereo's (N, 2) output
        lands as a true stereo file. An explicit count is validated
        against every block."""
        self._w = wave.open(path, "wb")
        self._rate = int(rate)
        self._channels = None if channels is None else int(channels)
        self._header_done = False
        self.frames_written = 0

    def _block_channels(self, data: np.ndarray) -> int:
        if data.ndim == 1:
            return 1
        if data.ndim == 2:
            return int(data.shape[1])
        raise ValueError(f"expected (N,) or (N, C) PCM, got shape "
                         f"{data.shape}")

    def __call__(self, pcm, _meta=None) -> None:
        data = _to_int16(to_numpy(pcm))
        nch = self._block_channels(data)
        if self._channels is None:
            self._channels = nch
        elif nch != self._channels:
            raise ValueError(
                f"PCM block has {nch} channel(s) but this WavSink was "
                f"opened with channels={self._channels}")
        if not self._header_done:
            self._w.setnchannels(self._channels)
            self._w.setsampwidth(2)
            self._w.setframerate(self._rate)
            self._header_done = True
        self._w.writeframes(data.tobytes())
        self.frames_written += data.shape[0] if data.ndim else 0

    def close(self) -> None:
        if not self._header_done:  # no blocks: emit a valid empty file
            self._w.setnchannels(self._channels or 1)
            self._w.setsampwidth(2)
            self._w.setframerate(self._rate)
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
