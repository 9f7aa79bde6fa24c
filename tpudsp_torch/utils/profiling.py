"""Tracing / profiling / observability (port of
``tpudsp/utils/profiling.py``; SURVEY.md section 5).

The reference's only observability is per-object stdout ``print()``
(resampler.hpp:101-103 etc.); here:

- ``annotate(name)``: a named span for chain stages: a
  ``torch.profiler.record_function`` range (in torch.profiler traces),
  plus an NVTX range when CUDA is present.
- ``trace(logdir)``: capture a torch.profiler trace (CPU and, when CUDA
  is present, CUDA activity) around a block of work, written into
  ``logdir`` as a Chrome trace.
- ``stage_report(...)``: host-side structured per-block metrics (rssi,
  squelch state counts, output levels) mirroring the reference's print
  surface but as data.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np
import torch

from ..ops.base import to_numpy


@contextlib.contextmanager
def annotate(name: str):
    """Named trace span; also a no-op context outside profiling sessions."""
    nvtx = torch.cuda.is_available()   # a CPU-only torch raises in range_push
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the enclosed block into ``logdir``
    (a Chrome trace named by
    ``torch.profiler.tensorboard_trace_handler``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def stage_report(name: str, *, out=None, modes=None, extra=None, file=sys.stderr):
    """Emit one structured JSON metrics line for a processed block; ``out``
    and ``modes`` may be numpy arrays or tensors on any device."""
    rec = {"stage": name}
    if out is not None:
        o = to_numpy(out)
        power = float(np.mean(np.abs(o) ** 2)) if o.size else 0.0
        rec["out_rms"] = float(np.sqrt(power))
        rec["out_len"] = int(o.shape[-1]) if o.ndim else 0
    if modes is not None:
        m = to_numpy(modes)
        vals, counts = np.unique(m, return_counts=True)
        rec["squelch_modes"] = {int(v): int(c) for v, c in zip(vals, counts)}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), file=file, flush=True)
    return rec
