"""What the traced window's profiler trace says, reduced to a small
summary the per-layer metrics read.

Device activity is every CUDA event of ``torch.profiler`` (kernels,
copies, sets); host spans are the CPU ranges named by
``record_function`` (the harness's ``bench.call`` and ``bench.sync`` and
the program's own spans). The window runs from the first ``bench.call``
to the end of the last ``bench.sync``.
"""

from __future__ import annotations

import re

from torch.autograd import DeviceType

KEEP_GAPS = 10          # the breakdown lists the ten longest idle gaps
HOST_SPAN = re.compile(r"^(bench\.|[A-Za-z_][A-Za-z0-9_]*\.[A-Za-z_][A-Za-z0-9_.]*$)")


def kernel_pattern(names):
    """A regex matching any of the trace names as a whole identifier."""
    alt = "|".join(re.escape(n) for n in names)
    return re.compile(rf"(?<![A-Za-z0-9_])(?:{alt})(?![A-Za-z0-9_])")


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, hand_kernels: dict) -> dict:
    """The summary of the traced window from the profiler's ``events()``:
    window and busy seconds, each device operation's count and seconds, the
    kernel count, the hand kernels' counts and seconds (by
    ``hand_kernels``: name -> its kernels/<name>.json), and the longest
    idle gaps named by the innermost host span around them."""
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, s, t, getattr(e, "is_user_annotation", False)))
        elif HOST_SPAN.match(e.name):
            host.append((e.name, s, t))
    # a record_function range also shows on the device's timeline (a user
    # annotation): it is a span, not device work
    spans = {h[0] for h in host}
    dev = [(n, s, t) for n, s, t, ann in dev if not ann and n not in spans]
    calls = [h for h in host if h[0] == "bench.call"]
    syncs = [h for h in host if h[0] == "bench.sync"]
    if not calls or not syncs:
        raise RuntimeError("the trace holds no bench.call / bench.sync span")
    w0, w1 = min(h[1] for h in calls), max(h[2] for h in syncs)
    dev = [(n, max(s, w0), min(t, w1)) for n, s, t in dev if t > w0 and s < w1]
    ops: dict = {}
    for n, s, t in dev:
        c = ops.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (t - s) * 1e-6
    busy = _merge([(s, t) for _, s, t in dev])
    busy_s = sum(t - s for s, t in busy) * 1e-6
    gaps, prev = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    gaps.sort(key=lambda g: g[0] - g[1])

    def name_of(gap):
        mid = 0.5 * (gap[0] + gap[1])
        around = [h for h in host if h[1] <= mid <= h[2]]
        return min(around, key=lambda h: h[2] - h[1])[0] if around else "host"

    hand = {}
    for k, spec in hand_kernels.items():
        pat = kernel_pattern(spec["trace"])
        mine = [(n, c) for n, c in ops.items() if pat.search(n)]
        hand[k] = {"trace": sum(c[0] for _, c in mine),
                   "seconds": sum(c[1] for _, c in mine)}
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "ops": ops,
        "kernels": sum(c[0] for n, c in ops.items() if is_kernel(n)),
        "hand": hand,
        "gaps": [[name_of(g), (g[1] - g[0]) * 1e-6] for g in gaps[:KEEP_GAPS]],
    }
