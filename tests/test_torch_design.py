"""The port's copies of the filter designers equal tpudsp's bit for bit."""

import numpy as np
import pytest

from tpudsp.chains.am import AMConfig
from tpudsp.design import firdes as jfir
from tpudsp.design import iirdes as jiir
from tpudsp_torch.design import firdes as tfir
from tpudsp_torch.design import iirdes as tiir


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,fc,As,npfb", [
    (13, 0.45 * AMConfig().rate, 60.0, 64),   # the AM receiver's bank
    (7, 0.2, 60.0, 32),
    (4, 0.45, 40.0, 16),
])
def test_resamp_bank_equal(m, fc, As, npfb):
    _same(tfir.resamp_bank(m, fc, As, npfb), jfir.resamp_bank(m, fc, As, npfb))


@pytest.mark.parametrize("m,As", [(25, 60.0), (12, 40.0), (3, 20.0)])
def test_hilbert_fir_equal(m, As):
    _same(tfir.hilbert_fir(m, As), jfir.hilbert_fir(m, As))


@pytest.mark.parametrize("ftype,order,bw", [
    ("cheby2", 8, 15000.0),          # AMConfig defaults
    ("cheby2", 4, 10000.0),
    ("cheby2", 6, 25000.0),
    ("butter", 2, 5000.0),
    ("ellip", 5, 40000.0),
])
def test_iirdes_and_impulse_response_equal(ftype, order, bw):
    Fc = bw / AMConfig().iq_rate
    sos_t = tiir.iirdes_sos(ftype, "lowpass", order, Fc, As=60.0, Ap=0.5)
    sos_j = jiir.iirdes_sos(ftype, "lowpass", order, Fc, As=60.0, Ap=0.5)
    _same(sos_t, sos_j)
    _same(tiir.sos_impulse_response(sos_t, tol=1e-11),
          jiir.sos_impulse_response(sos_j, tol=1e-11))


def test_tf2sos_equal():
    b, a = [0.2, 0.3, 0.1, 0.05], [1.0, -0.5, 0.2, -0.1]
    _same(tiir.tf2sos(b, a), jiir.tf2sos(b, a))
    _same(tiir.tf2sos([1.0, 0.5], [2.0, -0.4]), jiir.tf2sos([1.0, 0.5], [2.0, -0.4]))


@pytest.mark.parametrize("rate", [48000.0, 44100.0, 32000.0])
def test_deemphasis_coeffs_equal(rate):
    assert tiir.deemphasis_coeffs(rate) == jiir.deemphasis_coeffs(rate)


@pytest.mark.parametrize("m,As", [(25, 20.0), (64, 40.0), (5, 60.0)])
def test_dc_blocker_equal(m, As):
    _same(tfir.dc_blocker(m, As), jfir.dc_blocker(m, As))


@pytest.mark.parametrize("rate", [0.024, 0.5, 2.0, 1e-5])
def test_default_resamp_params_equal(rate):
    assert tfir.default_resamp_params(rate) == jfir.default_resamp_params(rate)


def test_freqresponses_equal():
    f = np.linspace(0.0, 0.5, 17)
    h = jfir.kaiser_lowpass(51, 0.1, 60.0)
    _same(tfir.freqresponse(h, f), jfir.freqresponse(h, f))
    assert tfir.freqresponse(h, 0.1) == jfir.freqresponse(h, 0.1)
    sos = jiir.iirdes_sos("cheby2", "lowpass", 8, 0.0075, As=60.0)
    _same(tiir.sos_freqresponse(sos, f), jiir.sos_freqresponse(sos, f))
    assert tiir.sos_freqresponse(sos, 0.0) == jiir.sos_freqresponse(sos, 0.0)


@pytest.mark.parametrize("m,As", [(5, 60.0), (12, 40.0), (3, 20.0)])
def test_halfband_lowpass_equal(m, As):
    _same(tfir.halfband_lowpass(m, As), jfir.halfband_lowpass(m, As))


@pytest.mark.parametrize("rate", [600000.0, 240000.0, 44100.0 * 4])
def test_stereo_audio_lowpass_equal(rate):
    _same(tfir.stereo_audio_lowpass(rate), jfir.stereo_audio_lowpass(rate))
