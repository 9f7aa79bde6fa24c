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


def on_cuda(kernel: str, device):
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {device}")


def launch(kernel: str, device, *args, source: str | None = None):
    """Call the C entry point ``kernel`` of csrc/<source>.cu (``source``
    defaults to ``kernel``) on ``device``'s current stream with ``args``
    (tensors as their data pointers, ints as they are); raise if the launch
    was refused."""
    lib = build.load(source or kernel)
    args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, kernel)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
