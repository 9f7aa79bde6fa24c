"""Argument checks and the launch of a kernel built by ``build.py``: the
part every wrapper in ``cuda/`` shares."""

from __future__ import annotations

import torch

from . import build


def check(kernel: str, name: str, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


# memo's entries: (tag, tensor identities) -> (tensors, versions, value);
# an entry keeps its tensors alive, so no other tensor takes their
# identities while it lives
_memo: dict = {}


def memo(tag: str, tensors, make):
    """``make()``, made once for ``tensors`` (None entries allowed) while
    none of them is replaced or changed in place: a wrapper's argument
    derived from parameters that stay the same from call to call, made
    without a device op every call."""
    key = (tag, *map(id, tensors))
    versions = tuple(None if t is None else t._version for t in tensors)
    hit = _memo.get(key)
    if hit is None or hit[1] != versions:
        if len(_memo) >= 64:
            _memo.clear()
        hit = _memo[key] = (tuple(tensors), versions, make())
    return hit[2]


def on_cuda(kernel: str, device):
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {device}")


# the current stream's raw handle by device index, without the Stream
# object that torch.cuda.current_stream builds on every call (host time
# that a small launch feels); the public call where this torch lacks it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(device) -> int:
    """The handle of ``device``'s current stream."""
    if _raw_stream is not None and device.index is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def launch(kernel: str, device, *args, source: str | None = None, on: int | None = None):
    """Call the C entry point ``kernel`` of csrc/<source>.cu (``source``
    defaults to ``kernel``) on the stream ``on`` (``device``'s current
    stream by default) with ``args`` (tensors as their data pointers, ints
    as they are); raise if the launch was refused."""
    lib = build.load(source or kernel)
    args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    stream_ = stream(device) if on is None else on
    if device.index is None or device.index == torch.cuda.current_device():
        rc = getattr(lib, kernel)(*args, stream_)
    else:   # the launch goes to the current device: make it device's
        with torch.cuda.device(device):
            rc = getattr(lib, kernel)(*args, stream_)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


# per (device, stream): [scratch, blocks started on it, last epoch]. The
# blocked scans' blocks (csrc/tile_chain.cuh) take their tiles by a
# counter in the scratch and pass their tiles' entries on through links in
# it, flagged with the launch's epoch: launches on one stream run in
# order, so every blocked scan on it shares the buffer without clearing it.
# Every kernel's links are LINK int32 wide with the flag last, so a flag
# slot never holds another kernel's value.
# One thread enqueues on a stream: a launch's ticket base is taken here
# and its blocks count from it in launch order, so two threads enqueuing
# on one stream could take bases in one order and launch in the other,
# and the later launch's blocks would take tickets past its grid. The
# port holds to it: a thread launches on its current stream, and every
# io.StreamRuntime pumps on a stream of its own (io/stream.py).
_chains: dict = {}
_EPOCHS = 2 ** 31 - 1
LINK = 8


def chain(dev, stream: int, links: int, blocks: int):
    """The stream's scratch, with room for ``links`` links, for a launch of
    ``blocks`` blocks; its block count before the launch (as a C int) and
    the launch's epoch."""
    size = 4 + LINK * links
    st = _chains.get((dev, stream))
    if st is None or st[0].numel() < size:
        st = _chains[(dev, stream)] = [torch.zeros(max(size, 4096), dtype=torch.int32,
                                                   device=dev), 0, 0]
    if st[2] == _EPOCHS:   # every epoch used: clear the flags, start again
        st[0].zero_()
        st[1:] = [0, 0]
    st[2] += 1
    base = st[1]
    st[1] = (base + blocks) % 2 ** 32
    return st[0], base - 2 ** 32 if base >= 2 ** 31 else base, st[2]
