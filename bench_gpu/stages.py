"""The chains' stage spans, read back: each stage's host time from the
program's span recorder, and its device time from a profiler trace.

A chain step has three roles (``ROLES``): its front end, its demodulator
(and de-emphasis), and its glue, the step span's own time outside the two
(the transposes into and out of the (C, M) layout, the carried-state
clones, ``BlockMetrics``). A cell's chain uses one name of each role.

- ``span_window``: ``harness.TRACED_BLOCKS`` blocks, fed as the measured
  window feeds them, under the program's span recorder with the profiler
  off; the recorder's table and the host time a block around each call.
- ``assign``: each device event of a profiler window to the innermost
  program span around the host call that launched it. The link is the
  launch's correlation id: the device event shares it with its launch call
  (a ``cuda*`` or ``cu*`` API event), whose ``cpu_parent`` chain reaches
  the span. This covers the hand kernels' ctypes launches as well as
  aten's. The host runs blocks ahead of the card, so a device event's own
  time says nothing of the span that launched it.
- ``host_ms`` and ``device_ms``: the three roles a block.
"""

from __future__ import annotations

import collections
import re
import time

from torch.autograd import DeviceType

from . import harness, trace

ROLES = {
    "front": ("am_step.front", "bank_step.channelize"),
    "demod": ("am_step.back", "bank_step.demod"),
    "glue": ("AMReceiver.step", "ChannelizedBank.step"),
}
COVER_MIN = 0.99        # below it the stage device times are left out
LAUNCH = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")   # launch calls that reach the card


def program_span(name: str) -> bool:
    return bool(trace.HOST_SPAN.match(name)) and not name.startswith("bench.")


def span_window(run, prog, g: int):
    """``harness.TRACED_BLOCKS`` blocks from ring slot ``g`` under the span
    recorder: {"table": the recorder's table, "host_ms": host time a block
    inside the calls, "blocks"}; None where the program has no recorder."""
    try:
        from tpudsp_torch.utils.profiling import record_spans, reset_spans, span_table
    except ImportError:
        return None
    R = int(run.mix["ring_blocks"])
    ahead = int(run.params.get("ahead", 0))
    clock = harness.Clock(run.device, ahead)
    pending = collections.deque()
    host_ns = 0
    reset_spans()
    with record_spans():
        for _ in range(harness.TRACED_BLOCKS):
            t = clock.start()
            h0 = time.perf_counter_ns()
            out = prog(run.ring[g % R])
            host_ns += time.perf_counter_ns() - h0
            clock.stop(t)
            pending.append(t)
            del out
            g += 1
            if len(pending) > ahead:
                clock.wait_ms(pending.popleft())
    harness.sync(run.device)
    table = span_table()
    reset_spans()
    n = harness.TRACED_BLOCKS
    return {"table": table, "host_ms": host_ns * 1e-6 / n, "blocks": n}


def assign(events) -> dict:
    """Of a traced window's profiler events (the window as
    ``trace.summarize`` takes it): device seconds by the innermost program
    span that launched them (``stage_ops``), the share of the window's
    device seconds so assigned (``stage_cover``), and the launch calls in
    the window with no device event (``launches_unmatched``)."""
    events = list(events)
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    spans = {e.name for e in host if trace.HOST_SPAN.match(e.name)}
    calls = [e.time_range for e in host if e.name == "bench.call"]
    syncs = [e.time_range for e in host if e.name == "bench.sync"]
    if not calls or not syncs:
        raise RuntimeError("the trace holds no bench.call / bench.sync span")
    w0, w1 = min(r.start for r in calls), max(r.end for r in syncs)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False) and e.name not in spans
           and e.time_range.end > w0 and e.time_range.start < w1]
    launches = {e.id: e for e in host if LAUNCH.match(e.name) and w0 <= e.time_range.start <= w1}
    ops: dict = {}
    total = 0.0
    for e in dev:
        s = (min(e.time_range.end, w1) - max(e.time_range.start, w0)) * 1e-6
        total += s
        owner = _owner(launches.get(e.id))
        if owner is not None:
            ops[owner] = ops.get(owner, 0.0) + s
    ids = {e.id for e in dev}
    return {"stage_ops": ops,
            "stage_cover": sum(ops.values()) / total if total else 0.0,
            "launches_unmatched": sum(1 for i in launches if i not in ids)}


def _owner(launch):
    p = launch.cpu_parent if launch is not None else None
    while p is not None and not program_span(p.name):
        p = p.cpu_parent
    return p.name if p is not None else None


def host_ms(spans: dict) -> dict:
    """Each role's recorder self time a block (ms): None where the span
    window found no span of the role."""
    out = {}
    for role, names in ROLES.items():
        got = [spans["table"][n]["self_ns"] for n in names if n in spans["table"]]
        out[role] = sum(got) * 1e-6 / spans["blocks"] if got else None
    return out


def device_ms(stages: dict, blocks: int) -> dict:
    """Each role's assigned device time a block (ms): None below
    ``COVER_MIN``, or where no device time was assigned to the role."""
    if stages["stage_cover"] < COVER_MIN:
        return {role: None for role in ROLES}
    ops = stages["stage_ops"]
    return {role: (sum(ops[n] for n in names if n in ops) * 1e3 / blocks
                   if any(n in ops for n in names) else None)
            for role, names in ROLES.items()}
