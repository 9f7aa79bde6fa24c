"""Tracing / profiling / observability (port of
``tpudsp/utils/profiling.py``; SURVEY.md section 5).

The reference's only observability is per-object stdout ``print()``
(resampler.hpp:101-103 etc.); here:

- ``annotate(name)``: a named span around a chain stage. With no
  ``torch.profiler`` running and the span recorder off it checks two
  flags and does nothing else; under a profiler it is a
  ``record_function`` range (on the profiler's clock, which its device
  events share); under the recorder it adds its host time to the
  recorder's table. Span names have the form ``Owner.stage``.
- ``record_spans()``, ``span_table()``, ``reset_spans()``: the span
  recorder. It keeps, in memory, each span name's count, total host time
  and self host time (the duration less what the span's direct child
  spans cover). It is off unless a caller turns it on; the chains never
  do.
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
import threading
import time

import numpy as np
import torch

_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


class _Recorder:
    """The span recorder's state: on or off, the table (name -> [count,
    total_ns, self_ns]) and, per thread, the stack of the open spans'
    child time."""

    def __init__(self):
        self.on = False
        self.table: dict = {}
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_rec = _Recorder()


class annotate:
    """A named span: ``with annotate("Owner.stage"): ...``."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._rf = self._t0 = None

    def __enter__(self):
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if _rec.on:
            _rec.stack().append(0)
            self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            dur = _clock() - self._t0
            self._t0 = None
            st = _rec.stack()
            child = st.pop()
            if st:
                st[-1] += dur
            with _rec.lock:
                e = _rec.table.get(self.name)
                if e is None:
                    e = _rec.table[self.name] = [0, 0, 0]
                e[0] += 1
                e[1] += dur
                e[2] += dur - child
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        return False


@contextlib.contextmanager
def record_spans():
    """Turn the span recorder on for the enclosed block. The table keeps
    what earlier blocks recorded until ``reset_spans()``."""
    was, _rec.on = _rec.on, True
    try:
        yield
    finally:
        _rec.on = was


def span_table() -> dict:
    """name -> {"count", "total_ns", "self_ns"} of every span recorded."""
    with _rec.lock:
        return {n: {"count": c, "total_ns": t, "self_ns": s}
                for n, (c, t, s) in _rec.table.items()}


def reset_spans():
    """Clear the recorder's table."""
    with _rec.lock:
        _rec.table.clear()


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
    from ..ops.base import to_numpy
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
