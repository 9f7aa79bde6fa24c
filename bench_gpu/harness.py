"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, and the result line.

Each cell is a stream of blocks with the host ahead of the card: a step
calls the program's entry on the next block of the ring (already on the
card) and then waits for the block ``ahead`` blocks before it (the cell's
``params.ahead``), so the card is fed while the host stands still for
less than that many blocks. The stream is ring[0], ring[1], ... in order
and round again, so every block's carried state comes from the block
before it.

- ``samples_per_s`` (and the suffixed ``samples_per_s.am``, the same
  number under a cell class's own bound): every IQ sample of every block
  dispatched in the window over the window's seconds by the host clock.
  When the window's time is up nothing more is sent, every block sent is
  waited for, and the clock is read after that wait;
- ``block_ms_p95`` (and its suffixed names): the 95th percentile over all
  blocks of the window, each timed on the card's clock by CUDA events
  recorded on the current stream before the call and after its return:
  from the moment the card reaches the block to the end of its last
  operation, with any gap in it where the card waited for the host's
  enqueue;
- ``setup_s``: process start to the first timed block: loading, the
  ring, the program's build, the warm blocks, and on a checkout's first
  run the nvcc builds of the hand kernels.

Every run does the same work whatever the seed: the same block sizes in
the same order, the same count of warm blocks.
"""

from __future__ import annotations

import collections
import gc
import subprocess
import time

import numpy as np
import torch

from . import registry, signals, stats, trace
from .report import forbidden_modules, log

TRACED_BLOCKS = 24      # a few tens of blocks: long CUPTI windows drop activities
TRACE_TRIES = 3
JUDGED_BLOCKS = 2       # the judged pair: a block of the seed's ring slot and the next


class Clock:
    """Per-block times: a pair of CUDA events on the card, the host clock
    on the CPU (the CPU path exists for the tests only). Event pairs are
    reused from a pool as large as the blocks in flight."""

    def __init__(self, device, inflight: int):
        self.cuda = device.type == "cuda"
        self.pool = [[torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)] if self.cuda else [0.0, 0.0]
                     for _ in range(inflight + 1)]
        self.i = 0

    def start(self):
        """A new block's timer, started."""
        t = self.pool[self.i]
        self.i = (self.i + 1) % len(self.pool)
        if self.cuda:
            t[0].record()
        else:
            t[0] = time.perf_counter()
        return t

    def stop(self, t):
        if self.cuda:
            t[1].record()
        else:
            t[1] = time.perf_counter()

    def wait_ms(self, t) -> float:
        """Wait for the block's end; its time."""
        if self.cuda:
            t[1].synchronize()
            return t[0].elapsed_time(t[1])
        return (t[1] - t[0]) * 1e3


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def read_counter(path: str) -> int:
    """``module:attr.attr`` -> that object's ``launches``."""
    mod, attrs = path.split(":")
    obj = __import__(mod, fromlist=["_"])
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj.launches)


def hand_counts(kernels: dict) -> dict:
    return {k: sum(read_counter(c) for c in spec["counters"]) for k, spec in kernels.items()}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Run:
    """One run of a one-card cell. ``overrides`` (tests only) update the
    configuration's, the mix's and the cell's parameters; ``wrap`` (tests
    only) wraps the program the entry builds."""

    def __init__(self, cell_name: str, seed: int, seconds: float, traced: bool, t0: float,
                 device=None, overrides=None, wrap=None):
        self.cell = registry.workload(cell_name)
        self.seed, self.seconds, self.traced, self.t0 = seed, seconds, traced, t0
        self.device = torch.device(device if device is not None else "cuda:0")
        ov = overrides or {}
        self.cfg = _deep_update(registry.config(self.cell["config"]), ov.get("config", {}))
        self.mix = _deep_update(registry.traffic(self.cell["traffic"]), ov.get("traffic", {}))
        self.params = _deep_update(dict(self.cell.get("params", {})), ov.get("params", {}))
        self.entry = registry.entry(self.cell["entry"])
        self.kernels = registry.kernels()
        self.wrap = wrap

    def run(self) -> dict:
        """Set-up, the window, the traced window; returns what the result
        is made from (the judged pair stays on ``self``)."""
        dev = self.device
        phases = [("start", time.perf_counter())]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)
            phases.append(("CUDA context", time.perf_counter()))
        R = int(self.mix["ring_blocks"])
        self.ring = signals.make_ring(self.mix, self.seed, dev)
        sync(dev)
        phases.append(("ring", time.perf_counter()))
        prog = self.entry.build(self.cfg, self.params, self.mix, dev)
        sync(dev)
        phases.append(("build", time.perf_counter()))
        if self.wrap is not None:
            prog = self.wrap(prog)
        self.prog = prog
        g = 0
        for _ in range(int(self.params.get("warm_blocks", 2))):
            prog(self.ring[g % R])
            g += 1
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        phases.append(("warm blocks", time.perf_counter()))
        setup_s = time.perf_counter() - self.t0
        steps = ", ".join(f"{n} {t - p:.3f} s" for (_, p), (n, t) in zip(phases, phases[1:]))
        log(f"bench: set-up {setup_s:.3f} s: to the run "
            f"{phases[0][1] - self.t0:.3f} s, {steps}")

        # the window
        rng = np.random.default_rng(signals.rng_seed(self.seed) ^ 0x5EED)
        j = int(rng.integers(R))
        need = prog.prefix_blocks
        ahead = int(self.params.get("ahead", 0))
        clock = Clock(dev, ahead)
        times, host_s, held, self.pair = [], 0.0, None, None
        pending = collections.deque()
        start = time.perf_counter()
        deadline = start + self.seconds
        n = 0
        while True:
            block = self.ring[g % R]
            t = clock.start()
            h0 = time.perf_counter()
            out = prog(block)
            host_s += time.perf_counter() - h0
            clock.stop(t)
            pending.append(t)
            if held is not None and held[0] == g - 1:
                self.pair = (held[0], held[1], out.clone())
                held = None
            if g % R == j and g >= need:
                held = (g, out.clone())
            del out
            g += 1
            n += 1
            if len(pending) > ahead:
                times.append(clock.wait_ms(pending.popleft()))
            if time.perf_counter() >= deadline:
                break
        while pending:
            times.append(clock.wait_ms(pending.popleft()))
        sync(dev)
        window_s = time.perf_counter() - start
        q1, med, q3 = stats.quartiles(times)
        log(f"bench: window {window_s:.3f} s, {n} blocks, {ahead} ahead, block ms "
            f"median {med:.4f} q1 {q1:.4f} q3 {q3:.4f} max {max(times):.4f}")
        part = {
            "setup_s": setup_s,
            "blocks": n,
            "window_s": window_s,
            "times_ms": times,
            "host_ms": host_s * 1e3 / n,
            "work": prog.work(),
        }
        if self.traced:
            part["trace"] = self.traced_window(prog, g)
        part["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else 0)
        part["forbidden"] = forbidden_modules()
        return part

    def traced_window(self, prog, g: int) -> dict:
        """TRACED_BLOCKS blocks under torch.profiler, after one block that
        opens it, fed as the measured window feeds them (each wait for the
        block ``ahead`` before), with the harness's spans around each call
        and wait; tried again while a hand kernel's count in the trace
        differs from its wrapper's counter."""
        from torch.profiler import ProfilerActivity, profile, record_function
        dev = self.device
        R = int(self.mix["ring_blocks"])
        ahead = int(self.params.get("ahead", 0))
        clock = Clock(dev, ahead)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        for attempt in range(TRACE_TRIES):
            with profile(activities=acts) as prof:
                # one block before the window: the profiler's first block
                # carries its start-up gap, which is not the program's
                prog(self.ring[g % R])
                sync(dev)
                g += 1
                before = hand_counts(self.kernels)
                pending = collections.deque()
                for _ in range(TRACED_BLOCKS):
                    t = clock.start()
                    with record_function("bench.call"):
                        out = prog(self.ring[g % R])
                    clock.stop(t)
                    pending.append(t)
                    del out
                    g += 1
                    if len(pending) > ahead:
                        with record_function("bench.sync"):
                            clock.wait_ms(pending.popleft())
                with record_function("bench.sync"):
                    sync(dev)
            after = hand_counts(self.kernels)
            summary = trace.summarize(prof.events(), self.kernels)
            short = {k: (summary["hand"][k]["trace"], after[k] - before[k])
                     for k in self.kernels
                     if summary["hand"][k]["trace"] != after[k] - before[k]}
            summary["counts_ok"] = not short
            summary["blocks"] = TRACED_BLOCKS
            if not short:
                return summary
            log(f"bench: traced window {attempt + 1}: profiler count "
                f"differs from the wrapper's counter (trace, counter): {short}")
        return summary

    def judge(self) -> list:
        """The checks of the judged pair against the reference, once the
        program is freed."""
        self.prog = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if self.pair is None:
            return [{"name": "judged_pair", "value": 0, "limit": 1, "ok": False,
                     "why": "no block of the seed's ring slot and its successor completed "
                            "in the window after the prefix"}]
        g0, a, b = self.pair
        outs = [a.cpu(), b.cpu()]
        self.pair = None
        return self.entry.judge(self.cfg, self.params, self.mix, self.ring, g0, outs,
                                self.device)


def _deep_update(d: dict, u: dict) -> dict:
    d = dict(d)
    for k, v in u.items():
        d[k] = _deep_update(d.get(k, {}), v) if isinstance(v, dict) else v
    return d


def result(run: Run, p0: dict, checks: list) -> dict:
    """The result line from the run's part and the checks."""
    e2e = {
        "samples_per_s": stats.rate(p0["blocks"] * run.ring.shape[1], p0["window_s"]),
        "block_ms_p95": stats.percentile(p0["times_ms"], 95.0),
        "setup_s": p0["setup_s"],
    }
    metrics = {}
    if not run.traced:
        for m in run.cell["end_to_end"]:
            # a suffix names a cell class with its own bound: samples_per_s.am
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
    else:
        ctx = {
            "blocks": TRACED_BLOCKS,
            "trace": p0["trace"],
            "host_ms": p0["host_ms"],
            "work": p0["work"],
            "peaks": registry.peaks(),
        }
        for m in run.cell["per_layer"]:
            v = registry.metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = run.device
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": p0["memory_peak_bytes"],
    }
    out = {"correct": all(c["ok"] for c in checks),
           "attempted": p0["blocks"],
           "failed": 0 if all(c["ok"] for c in checks) else JUDGED_BLOCKS,
           "metrics": metrics, "device": device}
    if run.traced:
        tr = p0["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        ops = sorted(tr["ops"].items(), key=lambda kv: -kv[1][1])[:10]
        out["breakdown"] = {"device_ops": [[n[:160], c[1]] for n, c in ops],
                            "idle_gaps": tr["gaps"]}
    out["card"] = card_line() if dev.type == "cuda" else "cpu"
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def run_single(cell_name: str, seed: int, seconds: float, traced: bool, t0: float, **kw):
    """One run: (result, checks)."""
    run = Run(cell_name, seed, seconds, traced, t0, **kw)
    part = run.run()
    if part["forbidden"]:
        raise RuntimeError(f"loaded after the window: {part['forbidden']}")
    checks = run.judge()
    return result(run, part, checks), checks
