"""The port's spans (tpudsp_torch.utils.profiling.annotate), its span
recorder and am_front_scan's dependent-step counter on the CPU, and the
benchmark's readers of them (bench_gpu/stages.py, trace.summarize,
metrics/am_front_scan.ns_per_step.py) on synthetic profiler events."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bench_gpu import registry, stages
from bench_gpu import trace as btrace
from tpudsp_torch.chains import AMConfig, AMReceiver
from tpudsp_torch.chains.channelizer import (ChannelizedBank, ChannelizedBankConfig,
                                             ChannelizerConfig)
from tpudsp_torch.utils import profiling
from tpudsp_torch.utils.profiling import annotate, record_spans, reset_spans, span_table


@pytest.fixture(autouse=True)
def _empty_table():
    reset_spans()
    yield
    reset_spans()


def test_annotate_off_opens_no_range_and_records_nothing(monkeypatch):
    """With no profiler and the recorder off a span only checks its flags."""
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) opened outside a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not torch.autograd._profiler_enabled()
    with annotate("Owner.stage"):
        with annotate("Owner.inner"):
            torch.ones(4).sum()
    assert span_table() == {}


def test_annotate_returns_its_result_and_raises_through():
    with annotate("Owner.stage") as s:
        pass
    assert s.name == "Owner.stage"
    with pytest.raises(ValueError):
        with record_spans(), annotate("Owner.stage"):
            raise ValueError("through")
    assert span_table()["Owner.stage"]["count"] == 1
    assert not profiling._rec.on and profiling._rec.stack() == []


def test_recorder_counts_and_self_times_of_nested_spans(monkeypatch):
    """step [0, 100) holds front [10, 30) and demod [40, 90), demod holds
    inner [50, 60); a second step [200, 205) holds nothing."""
    ticks = iter([0, 10, 30, 40, 50, 60, 90, 100, 200, 205])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    with record_spans():
        with annotate("Chain.step"):
            with annotate("chain.front"):
                pass
            with annotate("chain.demod"):
                with annotate("chain.inner"):
                    pass
        with annotate("Chain.step"):
            pass
    t = span_table()
    assert t["Chain.step"] == {"count": 2, "total_ns": 105, "self_ns": 105 - 20 - 50}
    assert t["chain.front"] == {"count": 1, "total_ns": 20, "self_ns": 20}
    assert t["chain.demod"] == {"count": 1, "total_ns": 50, "self_ns": 40}
    assert t["chain.inner"] == {"count": 1, "total_ns": 10, "self_ns": 10}
    reset_spans()
    assert span_table() == {}


def test_recorder_is_off_outside_its_block():
    with annotate("Owner.before"):
        pass
    with record_spans():
        with annotate("Owner.during"):
            pass
    with annotate("Owner.after"):
        pass
    assert set(span_table()) == {"Owner.during"}
    assert span_table()["Owner.during"]["self_ns"] >= 0


def test_annotate_and_the_recorder_under_a_profiler():
    """Both at once: the profiler sees the range, the recorder its time."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, record_spans():
        with annotate("Owner.stage"):
            torch.ones(16).cumsum(0)
    assert "Owner.stage" in {e.name for e in prof.events()}
    assert span_table()["Owner.stage"]["count"] == 1


def _am():
    # 12,500 samples: 300 pcm samples, so the back end runs its exact front
    rx = AMReceiver(AMConfig(), block_len=12_500, device="cpu")
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(12_500)
                          * 0.1).astype(np.complex64))
    return rx, x, ("AMReceiver.step", ("am_step.front", "am_step.back"))


def _bank(demod):
    ch = ChannelizerConfig(nchan=8, taps_per_branch=8, iq_rate=800_000.0)
    bank = ChannelizedBank(ChannelizedBankConfig(channelizer=ch, demod=demod,
                                                 am_coherent=True, agc_bandwidth=0.05),
                           block_len=8 * 64, device="cpu")
    r = np.random.default_rng(2).standard_normal((2, 8 * 64))
    x = torch.from_numpy((r[0] + 1j * r[1]).astype(np.complex64))
    return bank, x, ("ChannelizedBank.step", ("bank_step.channelize", "bank_step.demod"))


@pytest.mark.parametrize("make", [_am, lambda: _bank("fm"), lambda: _bank("am")],
                         ids=["am", "bank_fm", "bank_coherent_am"])
def test_chain_stage_spans_under_the_profiler(make):
    prog, x, (step, inner) = make()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog(x)
    spans = [e for e in prof.events()
             if btrace.HOST_SPAN.match(e.name) and not e.name.startswith("aten::")]
    assert sorted(e.name for e in spans) == sorted((step,) + inner)
    outer = next(e for e in spans if e.name == step)
    for e in spans:
        assert stages.program_span(e.name)
        if e.name != step:
            assert outer.time_range.start <= e.time_range.start
            assert e.time_range.end <= outer.time_range.end
    a, b = (next(e for e in spans if e.name == n) for n in inner)
    assert a.time_range.end <= b.time_range.start          # front, then demod
    names = {n for ns in stages.ROLES.values() for n in ns}
    assert {step, *inner} <= names


@pytest.mark.parametrize("make", [_am, lambda: _bank("fm")], ids=["am", "bank_fm"])
def test_chain_stage_spans_under_the_recorder(make):
    prog, x, (step, inner) = make()
    with record_spans():
        prog(x)
        prog(x)
    t = span_table()
    assert set(t) == {step, *inner}
    assert all(v["count"] == 2 for v in t.values())
    assert t[step]["total_ns"] >= sum(t[n]["total_ns"] for n in inner)
    assert t[step]["self_ns"] == t[step]["total_ns"] - sum(t[n]["total_ns"] for n in inner)
    host = stages.host_ms({"table": t, "blocks": 2})
    assert host["glue"] == pytest.approx(t[step]["self_ns"] * 1e-6 / 2)


# synthetic profiler events: what trace.summarize and stages.assign read

def _ev(name, s, t, dev=False, ann=False, id=0, parent=None):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=t),
                           device_type=DeviceType.CUDA if dev else DeviceType.CPU,
                           is_user_annotation=ann, id=id, cpu_parent=parent)


KERNELS = {"am_front_scan": {"trace": ["am_front_scan_kernel"], "counters": []}}


def _window(spans: bool):
    """Two blocks, the host one block ahead of the card: the kernels block 0
    launched run while the host is inside block 1's spans. Without
    ``spans`` the program's spans and their device-side annotations are
    left out."""
    ev = []
    k = 0
    for blk, (h0, d0) in enumerate([(0, 100), (100, 200)]):
        call = _ev("bench.call", h0, h0 + 90)
        ev.append(call)
        step = _ev("AMReceiver.step", h0 + 5, h0 + 85, parent=call)
        front = _ev("am_step.front", h0 + 10, h0 + 30, parent=step)
        back = _ev("am_step.back", h0 + 40, h0 + 80, parent=step)
        if spans:
            ev += [step, front, back,
                   _ev("AMReceiver.step", d0, d0 + 90, dev=True, ann=True),
                   _ev("am_step.front", d0, d0 + 10, dev=True),    # no annotation flag
                   _ev("am_step.back", d0 + 10, d0 + 80, dev=True, ann=True)]
        for owner, ks, kt, name, dur in [(front, 12, 14, "gemm_kernel", 10),
                                         (back, 42, 44, "am_front_scan_kernel", 70),
                                         (step, 82, 84, "cat_kernel", 5)]:
            k += 1
            parent = owner if spans else call
            ev.append(_ev("cudaLaunchKernel", h0 + ks, h0 + kt, id=1000 + k, parent=parent))
            start = d0 + {"gemm_kernel": 0, "am_front_scan_kernel": 10, "cat_kernel": 80}[name]
            ev.append(_ev(name, start, start + dur, dev=True, id=1000 + k))
    ev.append(_ev("bench.sync", 190, 300))
    return ev


def test_summarize_counts_no_span_annotation_as_device_work():
    a = btrace.summarize(_window(spans=False), KERNELS)
    b = btrace.summarize(_window(spans=True), KERNELS)
    for key in ("window_s", "busy_s", "ops", "kernels", "hand"):
        assert a[key] == b[key], key
    assert set(a["ops"]) == {"gemm_kernel", "am_front_scan_kernel", "cat_kernel"}


def test_assign_follows_the_launch_not_the_time():
    """Block 0's kernels run on the card while the host is inside block 1's
    spans: each is still assigned to the span that launched it."""
    got = stages.assign(_window(spans=True))
    assert got["stage_ops"] == pytest.approx({"am_step.front": 20e-6, "am_step.back": 140e-6,
                                              "AMReceiver.step": 10e-6})
    assert got["stage_cover"] == pytest.approx(1.0)
    assert got["launches_unmatched"] == 0
    ms = stages.device_ms(got, 2)
    assert ms == pytest.approx({"front": 0.01, "demod": 0.07, "glue": 0.005})


def test_assign_without_program_spans_and_with_a_lost_kernel():
    ev = _window(spans=False)
    got = stages.assign(ev)
    assert got["stage_ops"] == {} and got["stage_cover"] == 0.0
    assert stages.device_ms(got, 2) == {"front": None, "demod": None, "glue": None}
    ev = _window(spans=True)
    lost = next(e for e in ev if e.name == "am_front_scan_kernel")
    ev.remove(lost)
    got = stages.assign(ev)
    assert got["launches_unmatched"] == 1
    assert got["stage_cover"] == pytest.approx(1.0)      # of what the card ran
    orphan = next(e for e in ev if e.name == "cat_kernel")
    orphan.id = 1 << 30                                    # its launch event dropped
    got = stages.assign(ev)
    assert got["stage_cover"] == pytest.approx(1.0 - 5 / 100)
    assert stages.device_ms(got, 2)["front"] is None       # below COVER_MIN


def _front_params(C):
    from tpudsp_torch.kernels import agc as kagc
    from tpudsp_torch.kernels import am_backend as kab
    from tpudsp_torch.kernels.pll import PllState
    p = kab.make_params(kagc.make_params(alpha=0.01), 1.0, 0.1, 0.9, carrier=True)
    zeros = lambda: torch.zeros((C,), dtype=torch.float32)
    st = kab.FrontState(
        agc=kagc.AgcState(*(v.expand(C).contiguous() for v in kagc.agc_init())),
        pll=PllState(zeros(), zeros()))
    return p, st


@pytest.mark.parametrize("chunk,nchunks,warmup", [(1000, 5, 500), (700, 1, 0)],
                         ids=["chunked", "exact"])
def test_front_scan_launch_counts_its_steps(monkeypatch, chunk, nchunks, warmup):
    """The wrapper's bookkeeping with the card's calls stubbed: a launch adds
    its lanes' dependent steps, chunk + warmup (the exact form: L, 0)."""
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.cuda import launch
    for f in ("on_cuda", "check", "launch"):
        monkeypatch.setattr(launch, f, lambda *a, **k: None)
    C = 2
    p, st = _front_params(C)
    x = torch.zeros((chunk, C * nchunks))
    launches, steps = scan._launch.launches, scan._launch.steps
    scan._launch(p, st, x, x, nchunks, warmup)
    assert scan._launch.launches - launches == 1
    assert scan._launch.steps - steps == chunk + warmup


def test_ns_per_step_reader(monkeypatch):
    from tpudsp_torch.cuda import am_backend_scan as scan
    m = registry.metric("am_front_scan.ns_per_step")
    assert registry.metric("am_front_scan.ns_per_step.am").__name__ == m.__name__
    ctx = {"trace": {"counts_ok": True,
                     "hand": {"am_front_scan": {"trace": 24, "seconds": 24 * 2.1e-3}}}}
    monkeypatch.setattr(scan._launch, "launches", 10)
    monkeypatch.setattr(scan._launch, "steps", 76800)
    assert m.read(ctx) == pytest.approx(2.1e-3 * 1e9 / 7680)
    monkeypatch.delattr(scan._launch, "steps")               # a program without it
    assert m.read(ctx) is None
    ctx["trace"]["counts_ok"] = False
    assert m.read(ctx) is None
