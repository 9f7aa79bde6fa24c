"""The reference README's AMRadio, verbatim (examples/am_radio.py:15-31),
on ``tpudsp_torch.compat`` against the same class on ``tpudsp.compat``:
the same int16 IQ bytes (2^19 samples of a 1 kHz AM tone on a 200 Hz
carrier offset, as examples/am_radio.py makes them) through
``bytes_to_iq`` in 2^17-sample radio callbacks. Bar: >= 100 dB over the
settled second half of the pcm, port against tpudsp and each against the
float64 oracle chain built from the compat ops' own designs (the one
chip_smoke.py holds the card to). Measured on the CPU: port vs tpudsp
112.3 dB; vs the oracle, port 124.0 dB, tpudsp 111.6 dB. The ops run on
the CPU here (the fixture sets their default device).

Also the surface: ``__all__`` equals tpudsp.compat's (the classes beyond
the AMRadio's are held against their twins in tests/test_torch_surface.py).
"""

import numpy as np
import pytest
import scipy.signal as sig

import tpudsp.compat as jdsp
import tpudsp_torch.compat as tdsp
from tests.oracle.liquid_oracle import AgcOracle, FirstOrderOracle, ResampOracle
from tests.util import snr_db
from tpudsp_torch.design import firdes, iirdes
from tpudsp_torch.cuda import agc_scan, pll_scan
from tpudsp_torch.ops import base

N = 1 << 19
CALLBACK = 1 << 17


def am_radio_class(liquiddsp):
    class AMRadio:
        def __init__(self, bandwidth=15000, iq_rate=2000000, pcm_rate=48000):
            self.bandpass = liquiddsp.ComplexIIRFilter(
                filter_type="cheby2", order=8, Fc=bandwidth / iq_rate)
            self.resample = liquiddsp.ComplexResampler(
                rate=pcm_rate / iq_rate, Fc=pcm_rate / iq_rate)
            self.am = liquiddsp.AmpModem(modulation=0.5, type="dsb", carrier=True)
            self.audio_filter = liquiddsp.DeemphasisFilter(pcm_rate)
            self.agc = liquiddsp.AGC()
            self.agc.lock = False
            self.agc.scale = 0.01
            self.pcm = b""

        def __call__(self, iq):
            pcm = self.audio_filter(self.am(self.agc(self.resample(self.bandpass(iq)))))
            self.pcm += pcm.tobytes()
            return pcm

    return AMRadio


def raw_iq(n, iq_rate=2_000_000):
    """examples/am_radio.py's int16 IQ: a 1 kHz tone, 50% AM, 200 Hz off."""
    t = np.arange(n)
    msg = np.sin(2 * np.pi * 1000.0 / iq_rate * t)
    iq = (1 + 0.5 * msg) * 0.3 * np.exp(2j * np.pi * 200.0 / iq_rate * t)
    raw = np.empty(2 * n, np.int16)
    raw[0::2] = np.clip(iq.real * 32767, -32767, 32767)
    raw[1::2] = np.clip(iq.imag * 32767, -32767, 32767)
    return raw


def oracle_am_radio(iq, iq_rate=2e6, pcm_rate=48_000.0):
    """The float64 sample-serial oracle of the AMRadio chain with the compat
    ops' designs: the ComplexIIRFilter cheby2 bandpass (scipy's sosfilt,
    SosFilterOracle's recurrence), ResampOracle of resamp_bank(20, Fc, 60,
    13), AgcOracle with scale 0.01, the PLL + DC loop of
    tests/test_chain_snr.py, FirstOrderOracle de-emphasis."""
    rate = pcm_rate / iq_rate
    sos = iirdes.iirdes_sos("cheby2", "lowpass", 8, 15000 / iq_rate, 0.3, 0.7, 60.0)
    bb = sig.sosfilt(sos, np.asarray(iq, np.complex128))
    agc = AgcOracle(bandwidth=0.01)
    agc.scale = 0.01
    agc.sq_mode = 7  # squelch disabled
    y, _ = agc(ResampOracle(firdes.resamp_bank(20, rate, 60.0, 13), rate,
                            complex_data=True)(bb))
    theta, freq, dc = 0.0, 0.0, 0.0
    alpha, beta, rho = 0.001, np.sqrt(0.001), 0.9995
    out = np.empty(len(y))
    for n in range(len(y)):
        v = y[n] * np.exp(-1j * theta)
        err = np.angle(v) if abs(v) > 0 else 0.0
        freq += alpha * err
        theta = (theta + beta * err + freq + np.pi) % (2 * np.pi) - np.pi
        dc = rho * dc + (1 - rho) * v.real
        out[n] = (v.real - dc) / 0.5
    return FirstOrderOracle(*iirdes.deemphasis_coeffs(pcm_rate))(out)


@pytest.fixture(scope="module")
def pcm():
    """pcm of the AMRadio on tpudsp.compat ("jax"), on tpudsp_torch.compat
    on the CPU ("port"), and of the oracle, plus the two radios."""
    default = base.DEFAULT_DEVICE
    base.DEFAULT_DEVICE = "cpu"
    try:
        raw = raw_iq(N)
        radios = {lib: am_radio_class(lib)() for lib in (jdsp, tdsp)}
        for i in range(0, N, CALLBACK):
            chunk = raw[2 * i: 2 * (i + CALLBACK)].tobytes()
            for lib, radio in radios.items():
                assert radio(lib.bytes_to_iq(chunk)).dtype == np.float32
    finally:
        base.DEFAULT_DEVICE = default
    return {"jax": np.frombuffer(radios[jdsp].pcm, np.float32),
            "port": np.frombuffer(radios[tdsp].pcm, np.float32),
            "oracle": oracle_am_radio(jdsp.bytes_to_iq(raw.tobytes())),
            "radios": (radios[jdsp], radios[tdsp])}


def _settled_snr(ref, y):
    settle = len(ref) // 2
    return snr_db(ref[settle:], y[settle:])


def test_readme_am_radio_matches_tpudsp(pcm):
    yj, yt = pcm["jax"], pcm["port"]
    assert yt.shape == yj.shape and abs(len(yt) - N * 48 / 2000) <= 1
    assert np.all(np.isfinite(yt))
    s = _settled_snr(yj, yt)
    assert s >= 100.0, f"{s:.1f} dB"
    jr, tr = pcm["radios"]
    assert tr.agc.status == jr.agc.status
    assert agc_scan._launch.launches == 0 and pll_scan._launch.launches == 0


@pytest.mark.parametrize("side", ["port", "jax"])
def test_readme_am_radio_vs_float64_oracle(pcm, side):
    assert pcm[side].shape == pcm["oracle"].shape
    s = _settled_snr(pcm["oracle"], pcm[side])
    assert s >= 100.0, f"{side}: {s:.1f} dB"


def test_surface_matches_tpudsp_compat():
    assert tdsp.__all__ == jdsp.__all__
    assert len(tdsp.__all__) == 30
    for name in tdsp.__all__:
        assert callable(getattr(tdsp, name)), name

