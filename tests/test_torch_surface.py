"""The rest of the reference class surface on the port (``tpudsp_torch.
compat``: BroadcastAM, Delay, FMStereo, FreqDem, HilbertTransform, NCO,
SSBDemod), on the CPU (the fixture sets the ops' default device; without
it they ask for the card):

- each class against its ``tpudsp.compat`` twin over two blocks, with a
  third op handed over from the twin's state after the first block
  (``convert.op_state_from_jax``), at the bars below;
- the oracle bars of tests/test_oracle_composite.py and
  tests/test_demod.py (FIDELITY.md section 1) on the port: BroadcastAM >=
  110 dB against its float64 sample-serial oracle, SSBDemod >= 65 dB
  against the analytic reference and in rejection, the FMStereo mono path
  >= 30 dB against the reference-topology oracle, FreqDem's round trip
  >= 60 dB, and the NCO's mixing against liquid's 32-bit accumulator;
- the classes' own surface: properties, dtype errors, checkpoint/resume.

Measured on the CPU, port against tpudsp: Delay, HilbertTransform equal;
NCO 149.0 dB, FreqDem 152.6, SSBDemod 137.4, BroadcastAM 134.7, FMStereo
132.8 dB.
"""

import numpy as np
import pytest

import tpudsp.compat as jdsp
import tpudsp_torch.compat as tdsp
from tests.oracle.composite_oracle import BroadcastAMOracle, FMStereoOracle
from tests.oracle.fm_stereo_checks import mono_agreement, separation_db, stereo_composite
from tests.oracle.liquid_oracle import NcoOracle
from tests.util import noise, snr_db
from tpudsp_torch import convert
from tpudsp_torch.cuda import biquad_scan, first_order, pll_scan
from tpudsp_torch.kernels import lanes
from tpudsp_torch.ops import base

IQ_RATE = 600000.0
PCM_RATE = 48000.0


@pytest.fixture(autouse=True)
def cpu_ops(monkeypatch):
    monkeypatch.setattr(base, "DEFAULT_DEVICE", "cpu")


def _bam_signal(n):
    """tests/test_demod.py's broadcast AM: a 2 kHz message on a carrier
    at 0.001 cycles/sample, phase 0.5."""
    t = np.arange(n)
    m = np.sin(2 * np.pi * 2000.0 / 48000.0 * t)
    return ((1.0 + 0.5 * m) * np.exp(2j * np.pi * 0.001 * t + 1j * 0.5)).astype(np.complex64)


def _tone(n, f):
    return np.sin(2 * np.pi * f / IQ_RATE * np.arange(n))


def _nco(lib):
    nco = lib.NCO()
    nco.freq = 0.3
    nco.phase = 1.0
    return nco


def _c64(n, seed):
    return noise(n, seed=seed).astype(np.complex64)


def _f32(n, seed):
    return noise(n, complex_out=False, seed=seed).astype(np.float32)


# name: (make(lib), input of n samples, n, bar in dB against tpudsp)
CLASSES = {
    "BroadcastAM": (lambda L: L.BroadcastAM(), _bam_signal, 16_000, 120.0),
    "Delay": (lambda L: L.Delay(7), lambda n: _c64(n, 1), 2_000, 200.0),
    "FMStereo": (lambda L: L.FMStereo(IQ_RATE, PCM_RATE),
                 lambda n: stereo_composite(n, _tone(n, 800.0), _tone(n, 2300.0)),
                 30_000, 120.0),
    "FreqDem": (lambda L: L.FreqDem(0.1), lambda n: _c64(n, 2), 4_000, 140.0),
    "HilbertTransform": (lambda L: L.HilbertTransform(), lambda n: _c64(n, 3), 4_000, 140.0),
    "NCO": (_nco, lambda n: _c64(n, 4), 4_000, 140.0),
    "SSBDemod": (lambda L: L.SSBDemod("usb"), lambda n: _c64(n, 5), 4_000, 130.0),
}


def _score(ref, y, bar, what):
    ref, y = np.asarray(ref), np.asarray(y)
    assert y.shape == ref.shape and y.dtype == ref.dtype, what
    s = snr_db(ref, y)
    assert s > bar, f"{what}: {s:.1f} dB"


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_matches_tpudsp(name):
    """The class and its tpudsp twin on the same two blocks, and a port op
    that takes over the twin's state after the first block."""
    make, signal, n, bar = CLASSES[name]
    x = signal(n)
    a, b = x[:n // 2], x[n // 2:]
    jop, top = make(jdsp), make(tdsp)
    assert top.device.type == "cpu"
    _score(jop(a), top(a), bar, f"{name} block 1")
    handed = make(tdsp).with_state(convert.op_state_from_jax(jop.state, "cpu"))
    yj = jop(b)
    _score(yj, top(b), bar, f"{name} block 2")
    _score(yj, handed(b), bar, f"{name} handed over")


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_checkpoint_resume(name):
    """``state`` is a host pytree of numpy arrays and Python scalars;
    resuming a fresh op from it reproduces the stream bit for bit."""
    make, signal, n, _ = CLASSES[name]
    x = signal(n)
    op = make(tdsp)
    op(x[:n // 2])
    snapshot = op.state
    leaves = []
    lanes.tree_map(leaves.append, snapshot)
    assert leaves and all(isinstance(v, (np.ndarray, np.uint32, float, int)) for v in leaves)
    np.testing.assert_array_equal(op(x[n // 2:]), make(tdsp).with_state(snapshot)(x[n // 2:]))


# -- the oracle bars (FIDELITY.md section 1) --------------------------------
@pytest.mark.parametrize("exact_pll", [True, False])
def test_broadcastam_vs_oracle(exact_pll):
    """>= 110 dB past PLL lock against the sample-serial float64 oracle of
    the reference topology (tpudsp measures 137.1 dB), with the exact
    carrier scan and with the chunked one (its lanes re-derive their entry
    states over a 2048-sample warmup, exact after lock)."""
    x = _bam_signal(60_000)
    y_ref = BroadcastAMOracle(slen=25)(x)
    y = tdsp.BroadcastAM(exact_pll=exact_pll)(x)
    assert y.dtype == np.float32
    assert snr_db(y_ref[30_000:], y[30_000:].astype(np.float64)) > 110.0
    assert pll_scan._launch.launches == 0 and biquad_scan.sos_apply_df.launches == 0


@pytest.mark.parametrize("band", ["usb", "lsb"])
def test_ssbdemod_recovers_band(band):
    """>= 65 dB against the analytic reference, >= 65 dB rejection of the
    other band (the m = 25 Hilbert's own ripple: 71.7 dB in tpudsp)."""
    n, f = 30_000, 0.03
    sgn = 1.0 if band == "usb" else -1.0
    x = np.exp(sgn * 2j * np.pi * f * np.arange(n)).astype(np.complex64)
    y = tdsp.SSBDemod(band)(x)
    d = 2 * tdsp.SSBDemod.HILB_M
    ref = 2 * np.cos(2 * np.pi * f * (np.arange(n) - d))
    assert snr_db(ref[1000:-1000], y[1000:-1000]) > 65.0
    z = tdsp.SSBDemod("lsb" if band == "usb" else "usb")(x)
    assert 10 * np.log10(np.mean(y[1000:-1000] ** 2) / np.mean(z[1000:-1000] ** 2)) > 65.0


def test_freqdem_roundtrip():
    kd, n = 0.1, 20_000
    m = 0.8 * np.sin(2 * np.pi * 1000.0 / 48000.0 * np.arange(n))
    x = np.exp(1j * 2 * np.pi * kd * np.cumsum(m)).astype(np.complex64)
    assert snr_db(m[1:], tdsp.FreqDem(kd)(x)[1:]) > 60.0


def test_fmstereo_mono_path_vs_reference_topology():
    """tests/test_oracle_composite.py's pin on the port: mono (L == R)
    through freqdem -> de-emphasis at iq_rate -> resampling, against the
    sample-serial reference-topology oracle after a 10 kHz audio lowpass
    and fractional-delay alignment: gain within 10%, >= 30 dB (a
    cross-architecture bound: pilot squaring against the reference's
    pilot PLL)."""
    n = 120_000
    la = _tone(n, 1000.0) + 0.5 * _tone(n, 6300.0)
    x = stereo_composite(n, la, la)
    y_ref = FMStereoOracle(IQ_RATE, PCM_RATE, pll_bw=1e-5, warm_start=True)(x)[0::2]
    y = tdsp.FMStereo(iq_rate=IQ_RATE, pcm_rate=PCM_RATE)(x)[:, 0]
    g, snr = mono_agreement(y_ref, y, PCM_RATE)
    assert 0.9 < g < 1.1, f"mono gain mismatch: {g}"
    assert snr > 30.0
    assert first_order.first_order_apply_blocked_c64.launches == 0


def test_fmstereo_mono_and_separation():
    """tests/test_demod.py's FMStereo pins on the port: the mono path's
    channels agree >= 60 dB with the 1 kHz tone at its peak, and distinct
    L / R tones separate >= 60 dB after pilot lock (an (N, 2) float32
    output, N = n pcm_rate / iq_rate)."""
    n = 120_000
    la = _tone(n, 1000.0)
    y = tdsp.FMStereo(IQ_RATE, PCM_RATE)(stereo_composite(n, la, la))
    assert y.dtype == np.float32 and y.ndim == 2 and y.shape[1] == 2
    assert abs(len(y) - n * PCM_RATE / IQ_RATE) <= 1
    L, R = y[len(y) // 2:, 0], y[len(y) // 2:, 1]
    assert 10 * np.log10(np.mean(L ** 2) / (np.mean((L - R) ** 2) + 1e-30)) > 60.0
    spec = np.abs(np.fft.rfft(L * np.hanning(len(L))))
    assert abs(np.argmax(spec) * PCM_RATE / len(L) - 1000.0) < 30.0

    n = 600_000
    y = tdsp.FMStereo(IQ_RATE, PCM_RATE)(stereo_composite(n, _tone(n, 800.0),
                                                           _tone(n, 2300.0), scale=0.04))
    sep_l, sep_r = separation_db(y, 800.0, 2300.0, PCM_RATE)
    assert sep_l > 60.0
    assert sep_r > 60.0


def test_nco_vs_liquid_accumulator():
    """mix_up / mix_down against the float64 oracle of liquid's 32-bit
    phase accumulator (>= 120 dB), and the phase it carries on."""
    x = _c64(5000, 6)
    for direction in ("mix_up", "mix_down"):
        nco, orc = tdsp.NCO(), NcoOracle()
        nco.freq, nco.phase = 0.3, 1.0
        orc.set_frequency(0.3)
        orc.set_phase(1.0)
        y = np.concatenate([getattr(nco, direction)(x[:1234]),
                            getattr(nco, direction)(x[1234:])])
        assert y.dtype == np.complex64
        assert snr_db(getattr(orc, direction)(x), y) > 120.0
        assert int(nco.state["phase_u"]) == int(orc.phase_u)


def test_nco_properties_and_pll():
    """tests/test_ops_api.py's NCO checks on the port, and the PLL step
    against tpudsp's."""
    nco = tdsp.NCO()
    nco.freq = 0.3
    assert abs(nco.freq - 0.3) < 1e-9
    nco.phase = 1.0
    assert abs(nco.phase - 1.0) < 1e-6
    nco.adjust_phase(0.5)
    assert abs(nco.phase - 1.5) < 1e-6
    nco.adjust_frequency(-0.1)
    assert abs(nco.freq - 0.2) < 1e-9
    assert tdsp.NCO(type="xyz").type == "vco"
    jn, tn = jdsp.NCO(), tdsp.NCO()
    for o in (jn, tn):
        o.set_pll_bandwidth(0.02)
        for dphi in (0.1, -0.3, 0.05):
            o.pll_step(dphi)
    assert tn.freq == jn.freq and int(tn.state["phase_u"]) == int(jn.state["phase_u"])
    assert tn.state["pll_bw"] == jn.state["pll_bw"] == 0.02


def test_delay_dtype_dispatch_and_setter():
    """Independent real and complex lines; setting ``delay`` clears them;
    other dtypes and shapes raise TypeError."""
    d = tdsp.Delay(4)
    xc = (np.arange(8) + 1j).astype(np.complex64)
    xr = np.arange(8, dtype=np.float32)
    yc, yr = d(xc), d(xr)
    assert yc.dtype == np.complex64 and yr.dtype == np.float32
    np.testing.assert_array_equal(yc[4:], xc[:4])
    np.testing.assert_array_equal(yc[:4], 0)
    np.testing.assert_array_equal(yr[4:], xr[:4])
    d.delay = 2
    assert d.delay == 2
    np.testing.assert_array_equal(d(xr)[:2], 0)
    with pytest.raises(TypeError):
        d(np.arange(8))
    with pytest.raises(TypeError):
        d(np.zeros((2, 4), np.float32))


def test_hilbert_transform_rates_and_errors():
    h = tdsp.HilbertTransform()
    y = h(_c64(256, 7))
    assert y.dtype == np.float32 and len(y) == 512
    z = h(_f32(256, 8))
    assert z.dtype == np.complex64 and len(z) == 128
    with pytest.raises(ValueError, match="even"):
        h(_f32(255, 9))
    with pytest.raises(TypeError):
        h(np.arange(8))
    with pytest.raises(TypeError):
        h(np.zeros((2, 4), np.complex64))
