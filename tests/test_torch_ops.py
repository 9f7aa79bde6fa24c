"""The port's reference class surface (``tpudsp_torch.compat``) against its
``tpudsp.compat`` twins, on the CPU (the ops' default device is set to
"cpu" by the fixture below; without it they ask for the card).

Every ported class the README's AMRadio uses runs over uneven block splits
next to its twin on the same numpy input, so carried state counts; a
stream is also handed over mid-flight from a tpudsp op to its port twin
through ``convert.op_state_from_jax``. Bars (port vs tpudsp): >= 100 dB,
output counts and squelch status equal. Measured on the CPU: AGC
130.2-131.8 dB over its three routes, ComplexIIRFilter 128.9 dB (short
TIRs bit-equal), resamplers 137.6-141.3 dB, AmpModem 117.0-117.8 dB with
the carrier PLL and 140.6 dB to bit-equal without, DeemphasisFilter
143.1 dB, hand-overs 112.5-143.0 dB; bytes_to_iq equal bit for bit. The property and default checks of tests/test_ops_api.py that
touch the ported classes are repeated on the port.
"""

import inspect

import numpy as np
import pytest
import torch

import tpudsp.compat as jdsp
import tpudsp_torch.compat as tdsp
from tests.oracle.liquid_oracle import SosFilterOracle
from tests.util import noise, snr_db, tones
from tpudsp.kernels.ampmodem import modulate
from tpudsp_torch import convert
from tpudsp_torch.chains import am as tam
from tpudsp_torch.cuda import agc_scan, pll_scan
from tpudsp_torch.kernels import lanes
from tpudsp_torch.ops import base


@pytest.fixture(autouse=True)
def cpu_ops(monkeypatch):
    monkeypatch.setattr(base, "DEFAULT_DEVICE", "cpu")


def _level_step(n):
    amp = np.where(np.arange(n) < n // 2, 0.05, 0.5)
    return (tones(n, [0.01]) * amp).astype(np.complex64)


def _am(n, am_type="dsb", carrier=True):
    """tests/test_oracle_composite.py's AmpModem signal."""
    t = np.arange(n)
    m = np.sin(2 * np.pi * 0.01 * t) + 0.3 * np.sin(2 * np.pi * 0.033 * t)
    return modulate(m, 0.5, am_type, carrier=carrier,
                    carrier_freq=0.0005 if carrier else 0.0).astype(np.complex64)


def _blocks(x, sizes):
    """x cut into consecutive blocks of the given sizes (the rest last)."""
    edges = np.cumsum([0, *sizes])
    return [x[a:b] for a, b in zip(edges[:-1], edges[1:])] + [x[edges[-1]:]]


def _stream(op, blocks):
    return [op(b) for b in blocks]


def _same_stream(jouts, touts, bar=100.0):
    assert [len(o) for o in touts] == [len(o) for o in jouts]
    assert all(t.dtype == j.dtype for t, j in zip(touts, jouts))
    j, t = np.concatenate(jouts), np.concatenate(touts)
    s = snr_db(j, t)
    assert s >= bar, f"{s:.1f} dB"


# -- AGC: the three routes ----------------------------------------------------
# name: (constructor kwargs, signal length, block sizes before the last)
AGC_ROUTES = {
    "exact": (dict(), 6000, [1000, 2377]),
    # chunk 1024, warmup 3840: blocks above 4864 samples run chunked
    "pallas": (dict(throughput_mode=True, use_pallas=True), 21_000,
               [9000, 3000]),
    # chunk = warmup = 3840: blocks above 7680 samples run chunked
    "xla": (dict(throughput_mode=True), 25_000, [9000, 4000]),
}


@pytest.mark.parametrize("route", list(AGC_ROUTES))
def test_agc_routes_match_tpudsp(route):
    kw, n, sizes = AGC_ROUTES[route]
    blocks = _blocks(_level_step(n), sizes)
    ops = []
    for lib in (jdsp, tdsp):
        agc = lib.AGC(**kw)
        agc.scale = 0.01
        ops.append(agc)
    _same_stream(_stream(ops[0], blocks), _stream(ops[1], blocks))
    assert ops[1].status == ops[0].status
    assert abs(ops[1].gain / ops[0].gain - 1) < 1e-5
    assert agc_scan._launch.launches == 0


def test_agc_squelch_onrise_matches_tpudsp():
    t = np.arange(12_000)
    amp = np.where((t % 6000 > 1500) & (t % 6000 < 3000), 1.0, 1e-4)
    x = (tones(len(t), [0.02]) * amp).astype(np.complex64)
    blocks = _blocks(x, [2222, 3100, 1900])
    rises, modes = {}, {}
    for name, lib in (("jax", jdsp), ("port", tdsp)):
        agc = lib.AGC()
        agc.squelch = True
        agc.threshold = 10.0
        rises[name] = []
        agc.onRise = lambda r=rises[name]: r.append(1)
        out = _stream(agc, blocks)
        modes[name] = (agc.status, out)
    assert len(rises["port"]) == len(rises["jax"]) >= 2
    assert modes["port"][0] == modes["jax"][0]
    _same_stream(modes["jax"][1], modes["port"][1])


# -- filters, resamplers, demodulators ---------------------------------------
FILTERS = {
    # the README AMRadio's bandpass: a 3240-tap TIR, overlap-save FFT
    "ComplexIIRFilter": lambda L: L.ComplexIIRFilter(
        filter_type="cheby2", order=8, Fc=15000 / 2e6),
    # a short TIR: the direct path
    "CLowpassIIR": lambda L: L.CLowpassIIR(order=2, Fc=0.2),
    "CBandpassIIR": lambda L: L.CBandpassIIR(order=2, Fc=0.05, F0=0.2),
    "CIIRFilter": lambda L: L.CIIRFilter(Bc=np.float32([0.5, 0.5]),
                                         Ac=np.float32([1.0, -0.3])),
}
REAL_FILTERS = {
    "RealIIRFilter": lambda L: L.RealIIRFilter(filter_type="ellip",
                                               band_type="highpass", order=3,
                                               Fc=0.1, Ap=0.5, As=50.0),
    "RBandstopIIR": lambda L: L.RBandstopIIR(order=2, Fc=0.02, F0=0.2),
    "DeemphasisFilter": lambda L: L.DeemphasisFilter(48000),
    "RealFIRFilter": lambda L: L.RealFIRFilter(np.float32([0.25, 0.5, 0.25])),
    "RealDCBlocker": lambda L: L.RealDCBlocker(),
    "RealKaiserBessel": lambda L: L.RealKaiserBessel(flen=51, Fc=0.1, As=60.0),
}
SPLIT = [1000, 1377, 4000, 333]


@pytest.mark.parametrize("name", list(FILTERS))
def test_complex_filters_match_tpudsp(name):
    blocks = _blocks(noise(10_000, seed=1).astype(np.complex64), SPLIT)
    _same_stream(_stream(FILTERS[name](jdsp), blocks),
                 _stream(FILTERS[name](tdsp), blocks))


@pytest.mark.parametrize("name", list(REAL_FILTERS))
def test_real_filters_match_tpudsp(name):
    blocks = _blocks(noise(10_000, complex_out=False, seed=2).astype(np.float32),
                     SPLIT)
    _same_stream(_stream(REAL_FILTERS[name](jdsp), blocks),
                 _stream(REAL_FILTERS[name](tdsp), blocks))


@pytest.mark.parametrize("cls,kw,cplx", [
    ("ComplexResampler", dict(rate=48000 / 2e6, Fc=48000 / 2e6), True),
    ("CResampler", dict(rate=0.3), True),
    ("RealResampler", dict(rate=1.7, Fc=0.2), False),
    ("RResampler", dict(rate=0.5), False),
])
def test_resamplers_match_tpudsp(cls, kw, cplx):
    """Per-call output counts equal exactly; values >= 100 dB; a rate change
    mid-stream keeps the state on both."""
    x = noise(30_000, complex_out=cplx, seed=3)
    blocks = _blocks(x.astype(np.complex64 if cplx else np.float32),
                     [7777, 20, 5000, 9000])
    jr, tr = getattr(jdsp, cls)(**kw), getattr(tdsp, cls)(**kw)
    jo, to = _stream(jr, blocks[:3]), _stream(tr, blocks[:3])
    jr.rate = tr.rate = kw["rate"] * 0.75
    jo += _stream(jr, blocks[3:])
    to += _stream(tr, blocks[3:])
    _same_stream(jo, to)
    assert tr.state["tau"] == jr.state["tau"]


@pytest.mark.parametrize("am_type,carrier", [
    ("dsb", True), ("usb", True), ("lsb", True),
    ("dsb", False), ("usb", False), ("lsb", False),
])
def test_ampmodem_matches_tpudsp(am_type, carrier):
    blocks = _blocks(_am(9000, am_type, carrier), [2000, 3333])
    jm = jdsp.AmpModem(modulation=0.5, type=am_type, carrier=carrier)
    tm = tdsp.AmpModem(modulation=0.5, type=am_type, carrier=carrier)
    _same_stream(_stream(jm, blocks), _stream(tm, blocks))
    assert pll_scan._launch.launches == 0


def test_bytes_to_iq_bit_equal():
    rng = np.random.default_rng(5)
    raw = rng.integers(-32768, 32768, size=20_002, dtype=np.int16).tobytes()
    for b in (raw, raw + b"\x01", raw[:3], b""):
        j, t = jdsp.bytes_to_iq(b), tdsp.bytes_to_iq(b)
        assert t.dtype == np.complex64 and t.shape == j.shape
        np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


# -- state: hand-over from tpudsp and checkpoint/resume -------------------
HANDOVER = {
    "AGC": (lambda L: L.AGC(), lambda n: _level_step(n) * 3),
    "AmpModem": (lambda L: L.AmpModem(modulation=0.5, type="usb",
                                       carrier=True),
                 lambda n: _am(n, "usb", True)),
    "ComplexResampler": (lambda L: L.ComplexResampler(rate=0.024, Fc=0.024),
                         lambda n: noise(n, seed=6).astype(np.complex64)),
    "ComplexIIRFilter": (FILTERS["ComplexIIRFilter"],
                         lambda n: noise(n, seed=7).astype(np.complex64)),
    "DeemphasisFilter": (REAL_FILTERS["DeemphasisFilter"],
                         lambda n: noise(n, complex_out=False, seed=8
                                         ).astype(np.float32)),
}


@pytest.mark.parametrize("name", list(HANDOVER))
def test_mid_stream_handover_from_tpudsp(name):
    make, sig = HANDOVER[name]
    x = sig(7000)
    jop = make(jdsp)
    jop(x[:4001])
    top = make(tdsp).with_state(convert.op_state_from_jax(jop.state, "cpu"))
    _same_stream(_stream(jop, _blocks(x[4001:], [1500])),
                 _stream(top, _blocks(x[4001:], [1500])))


@pytest.mark.parametrize("name", list(HANDOVER))
def test_state_checkpoint_resume(name):
    """``state`` is a host numpy pytree; resuming a fresh op from it
    reproduces the stream bit for bit."""
    make, sig = HANDOVER[name]
    x = sig(5000)
    op = make(tdsp)
    op(x[:2000])
    snapshot = op.state
    leaves = []
    lanes.tree_map(leaves.append, snapshot)
    assert leaves and all(isinstance(v, (np.ndarray, float)) for v in leaves)
    y_cont = op(x[2000:])
    y_resume = make(tdsp).with_state(snapshot)(x[2000:])
    np.testing.assert_array_equal(y_cont, y_resume)



# -- the property and default checks of tests/test_ops_api.py ---------------
def test_constructor_defaults():
    tdsp.RResampler(rate=0.5)
    tdsp.CResampler(rate=2.0)
    tdsp.CIIRFilter(Bc=np.float32([0.5, 0.5]), Ac=np.float32([1.0]))
    tdsp.CLowpassIIR(order=4, Fc=0.1)
    tdsp.CHighpassIIR(filter_type="cheby1", order=3, Fc=0.2, Ap=0.4)
    tdsp.CBandpassIIR(order=2, Fc=0.02, F0=0.2)
    tdsp.CBandstopIIR(order=2, Fc=0.02, F0=0.2, As=40.0)
    tdsp.RLowpassIIR(order=4, Fc=0.1)
    tdsp.RHighpassIIR(order=4, Fc=0.1)
    tdsp.RBandpassIIR(order=2, Fc=0.02, F0=0.2)
    tdsp.RBandstopIIR(order=2, Fc=0.02, F0=0.2)
    tdsp.ComplexIIRFilter()
    tdsp.RealIIRFilter(filter_type="ellip", band_type="highpass", order=3,
                       Fc=0.1, Ap=0.5, As=50.0)
    tdsp.DeemphasisFilter()
    am = tdsp.AmpModem()
    assert am.modulation == 0.75 and am.type == "dsb" and am.carrier is False
    tdsp.RealResampler(rate=0.5, Fc=0.2)
    tdsp.ComplexResampler(rate=0.5, len=12, Fc=0.2, As=50.0, nfilter=32)
    tdsp.AGC()
    tdsp.RealFIRFilter(np.float32([0.25, 0.5, 0.25]))
    tdsp.RealDCBlocker()
    tdsp.RealKaiserBessel(Fc=0.1)


def test_readme_am_radio_chain_constructs():
    bandwidth, iq_rate, pcm_rate = 15000, 2000000, 48000
    bandpass = tdsp.ComplexIIRFilter(filter_type="cheby2", order=8,
                                     Fc=bandwidth / iq_rate)
    resample = tdsp.ComplexResampler(rate=pcm_rate / iq_rate,
                                     Fc=pcm_rate / iq_rate)
    am = tdsp.AmpModem(modulation=0.5, type="dsb", carrier=True)
    audio_filter = tdsp.DeemphasisFilter(pcm_rate)
    agc = tdsp.AGC()
    agc.lock = False
    agc.scale = 0.01
    iq = noise(20000, complex_out=True, seed=0).astype(np.complex64)
    pcm = audio_filter(am(agc(resample(bandpass(iq)))))
    assert pcm.dtype == np.float32 and len(pcm) == 20000 * pcm_rate // iq_rate


def test_dtype_contract():
    f = tdsp.ComplexIIRFilter(order=2, Fc=0.1)
    assert f(np.zeros(64, np.complex64)).dtype == np.complex64
    assert f(torch.zeros(64, dtype=torch.complex64)).dtype == np.complex64
    with pytest.raises(TypeError):
        f(np.zeros(64, np.float32))
    with pytest.raises(TypeError):
        f(np.zeros((2, 64), np.complex64))
    with pytest.raises(TypeError):
        tdsp.DeemphasisFilter()(np.zeros(8, np.complex64))


def test_agc_properties():
    agc = tdsp.AGC()
    agc.bandwidth = 0.05
    assert agc.bandwidth == 0.05
    agc.gain = 2.0
    assert abs(agc.gain - 2.0) < 1e-6
    agc.level = 0.5
    assert abs(agc.level - 0.5) < 1e-6
    agc.level_dB = -20.0
    assert abs(agc.level_dB + 20.0) < 1e-4
    agc.scale = 0.01
    assert agc.scale == 0.01
    assert agc.status == 7
    agc.squelch = True
    assert agc.status == 1
    x = 0.3 * tones(2000, [0.01]).astype(np.complex64)
    agc.squelch = False
    y = agc(x)
    assert abs(np.abs(y[-200:]).mean() - agc.scale) / agc.scale < 0.2
    agc.lock = True
    g = agc.gain
    agc(x)
    assert agc.gain == g
    agc.reset()
    assert agc.lock is False and agc.squelch is False


def test_agc_squelch_zeroing_and_onrise():
    agc = tdsp.AGC()
    agc.squelch = True
    agc.threshold = 10.0
    rises = []
    agc.onRise = lambda: rises.append(1)
    n = 4000
    amp = np.where((np.arange(n) > 1500) & (np.arange(n) < 3000), 1.0, 1e-4)
    y = agc((tones(n, [0.02]) * amp).astype(np.complex64))
    assert len(rises) >= 1
    assert np.all(y[:100] == 0)
    assert np.abs(y[2500:2900]).mean() > 0


def test_amp_modem_properties_rebuild():
    am = tdsp.AmpModem()
    am.type = "usb"
    assert am.type == "usb"
    am.type = "bogus"
    assert am.type == "usb"
    am.modulation = 0.5
    am.carrier = True
    assert am.carrier is True and am.modulation == 0.5


def test_resampler_rate_property_and_reset():
    rs = tdsp.RealResampler(rate=0.5, Fc=0.2)
    x = noise(1000, complex_out=False, seed=3).astype(np.float32)
    assert abs(len(rs(x)) - 500) <= 1
    rs.rate = 0.25
    assert rs.rate == 0.25 and abs(len(rs(x)) - 250) <= 1
    rs.reset()
    assert np.allclose(rs(np.zeros(100, np.float32)), 0)
    assert rs(np.zeros(0, np.float32)).shape == (0,)


def test_resampler_output_length_long_run_exact():
    rate = 48000.0 / 2000000.0
    rs = tdsp.ComplexResampler(rate=rate, Fc=rate)
    x = noise(7777, complex_out=True, seed=4).astype(np.complex64)
    total_out = sum(len(rs(x)) for _ in range(20))
    assert abs(total_out - 20 * len(x) * rate) <= 1


def test_freqresponse_methods():
    f = tdsp.ComplexIIRFilter(filter_type="butter", order=4, Fc=0.1)
    assert abs(abs(f.freqresponse(0.0)) - 1.0) < 1e-3
    assert abs(f.freqresponse(0.4)) < 0.05
    kb = tdsp.RealKaiserBessel(flen=51, Fc=0.1, As=60.0)
    assert abs(abs(kb.freqresponse(0.0)) - 1.0) < 1e-6
    dc = tdsp.RealDCBlocker(slen=64, As=40.0)
    assert abs(dc.freqresponse(0.0)) < 1e-3
    assert abs(abs(dc.freqresponse(0.25)) - 1.0) < 0.1
    assert abs(abs(tdsp.DeemphasisFilter(48000).freqresponse(0.0)) - 1.0) < 1e-3


def test_print_methods(capsys):
    for obj in (tdsp.ComplexIIRFilter(), tdsp.RealResampler(rate=0.5, Fc=0.2),
                tdsp.AGC(), tdsp.AmpModem()):
        obj.print()
    assert len(capsys.readouterr().out.splitlines()) >= 4


def test_iir_scan_mode_matches_tpudsp():
    """mode="scan" runs the double-float SOS cascade: >= 130 dB against
    tpudsp's scan mode over two blocks, and a design whose impulse
    response does not fit in TIR_MAX_TAPS takes it under "auto" (>= 120
    dB against the float64 recurrence)."""
    x = noise(4000, seed=11).astype(np.complex64)
    jf = jdsp.CLowpassIIR(order=2, Fc=0.1, mode="scan")
    tf = tdsp.CLowpassIIR(order=2, Fc=0.1, mode="scan")
    assert tf.mode == jf.mode == "scan"
    for part in (x[:2000], x[2000:]):
        assert snr_db(jf(part), tf(part)) > 130.0
    assert tf.state.shape == (1, 2) and tf.state.dtype == np.complex64
    tf.reset()
    assert np.all(tf.state == 0)
    slow = tdsp.RLowpassIIR(order=2, Fc=1e-5)
    assert slow.mode == "scan"
    xr = noise(3000, complex_out=False, seed=12).astype(np.float32)
    assert snr_db(SosFilterOracle(slow._sos)(xr), slow(xr)) > 120.0


def test_default_device_is_the_card(monkeypatch):
    """Built without a device, the ops and the AM receiver ask for the card
    ("cuda"). Nothing probes for one: without a card, building on it
    raises."""
    monkeypatch.setattr(base, "DEFAULT_DEVICE", "cuda")
    assert base.resolve_device() == torch.device("cuda")
    assert base.resolve_device("cpu") == torch.device("cpu")
    assert inspect.signature(tam.AMReceiver).parameters["device"].default == "cuda"
    assert inspect.signature(tam.build).parameters["device"].default == "cuda"
    builds = (tdsp.AGC, tdsp.DeemphasisFilter,
              lambda: tam.AMReceiver(tam.AMConfig(), 50_000))
    for build in builds:
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                build()
