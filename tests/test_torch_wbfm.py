"""The port's WBFM receivers (``tpudsp_torch.chains.wbfm``, on the CPU)
against tpudsp's on the same numpy-seeded input, over blocks of 50,000
samples: mono (a one-channel bank) >= 90 dB in c64, i16 and u8 and
within 1 dB of tpudsp against the float64 FM-bank oracle; stereo >= 80
dB per channel in c64, i16 and u8, the JAX package's wire-format pin
(> 80 dB against the c64 chain on the dequantized samples), its stereo
separation pin (> 30 dB each way) and the audio decimator's uniform
sampling; ``convert.stereo_from_jax`` hands a stream over mid-flight."""

import numpy as np
import pytest
import torch

from tests.oracle import bank_oracle
from tests.oracle.fm_stereo_checks import separation_db
from tests.util import snr_db
from tpudsp.chains import wbfm as jwbfm
from tpudsp_torch import convert
from tpudsp_torch.chains import wbfm as twbfm
from tpudsp_torch.design import firdes, iirdes

FS = 2_400_000.0
N = 50_000


def _stereo_iq(n, la_hz=900.0, ra_hz=2500.0):
    """tests/test_chains.py:141-160's stereo FM at 2.4 Msps (kd = 4)."""
    t = np.arange(n)
    f_p = 19000.0 / FS
    la = np.sin(2 * np.pi * la_hz / FS * t)
    ra = np.sin(2 * np.pi * ra_hz / FS * t)
    comp = ((la + ra) / 2 + 0.1 * np.cos(2 * np.pi * f_p * t)
            + ((la - ra) / 2) * np.cos(2 * np.pi * 2 * f_p * t)) * 0.008
    return np.exp(1j * 2 * np.pi * np.cumsum(comp) * 4.0)


def _wire(x, fmt):
    """(c64 of the wire values, wire block)."""
    if fmt == "c64":
        return x.astype(np.complex64), x.astype(np.complex64)
    if fmt == "i16":
        w = np.clip(np.round(np.stack([x.real, x.imag], 1) * 32767), -32767, 32767).astype(np.int16)
        return ((w[:, 0] + 1j * w[:, 1]) / 32767.0).astype(np.complex64), w
    w = np.clip(np.round(np.stack([x.real, x.imag], 1) * 127.5 + 127.5), 0, 255).astype(np.uint8)
    return (((w[:, 0].astype(np.float32) - 127.5) + 1j * (w[:, 1].astype(np.float32) - 127.5))
            .astype(np.complex64) / np.float32(127.5)), w


def _blocks(x, k):
    return [x[i * N:(i + 1) * N] for i in range(k)]


def _port_stereo(blocks, fmt="c64"):
    rx = twbfm.WBFMStereoReceiver(block_len=N, input_format=fmt, device="cpu")
    return torch.cat([rx(torch.from_numpy(b)) for b in blocks]).numpy(), rx


def _jax_stereo(blocks, fmt="c64"):
    rx = jwbfm.WBFMStereoReceiver(block_len=N, input_format=fmt)
    return np.concatenate([np.asarray(rx(b)) for b in blocks]), rx


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_mono_matches_tpudsp(fmt):
    """Mono WBFM on a 75 kHz-deviation carrier 100 kHz off centre."""
    t = np.arange(2 * N)
    x = 0.7 * np.exp(1j * 2 * np.pi * np.cumsum(
        100e3 / FS + 75e3 / FS * np.sin(2 * np.pi * 1000.0 / FS * t)))
    xc, w = _wire(x, fmt)
    jr = jwbfm.mono_receiver(100e3, block_len=N)
    tr = twbfm.mono_receiver(100e3, block_len=N, device="cpu")
    if fmt != "c64":   # mono's bank on raw wire blocks
        jr = jwbfm.ReceiverBank(jr.cfg, block_len=N, input_format=fmt)
        tr = twbfm.ReceiverBank(tr.cfg, block_len=N, input_format=fmt, device="cpu")
    yj = np.concatenate([np.asarray(jr(b)) for b in _blocks(w, 2)], 1)
    yt = torch.cat([tr(torch.from_numpy(b)) for b in _blocks(w, 2)], 1).numpy()
    assert yt.shape == yj.shape == (1, 2 * N // 50)
    assert snr_db(yj[:, 50:], yt[:, 50:]) >= 90.0
    if fmt == "c64":
        cfg = tr.cfg
        ref = bank_oracle.fm_bank_f64(
            xc, tr.params.dtheta.numpy(), firdes.kaiser_lowpass(128, 0.045, 60.0),
            firdes.kaiser_lowpass(64, 0.09, 60.0), 10, 5, cfg.kd,
            *iirdes.deemphasis_coeffs(cfg.audio_rate))
        sj, st = snr_db(ref[:, 50:], yj[:, 50:]), snr_db(ref[:, 50:], yt[:, 50:])
        assert abs(sj - st) <= 1.0 and st >= 100.0, (sj, st)


@pytest.fixture(scope="module")
def stereo_runs():
    x = _stereo_iq(4 * N)
    out = {}
    for fmt in ("c64", "i16", "u8"):
        xc, w = _wire(x, fmt)
        out[fmt] = (_jax_stereo(_blocks(w, 4), fmt), _port_stereo(_blocks(w, 4), fmt), xc)
    return out


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_stereo_matches_tpudsp(stereo_runs, fmt):
    (yj, jr), (yt, tr), _ = stereo_runs[fmt]
    assert yt.shape == yj.shape == (4 * N // 50, 2) and yt.dtype == np.float32
    for c in range(2):
        s = snr_db(yj[200:, c], yt[200:, c])
        assert s >= 80.0, (c, s)
    assert abs(float(tr.metrics.pilot_level) - float(jr.metrics.pilot_level)) < 1e-5
    assert abs(float(tr.metrics.pll_freq) - float(jr.metrics.pll_freq)) < 1e-5


def test_stereo_separation(stereo_runs):
    """tests/test_chains.py:171-174: each tone > 30 dB stronger in its own
    channel."""
    (_, _), (yt, _), _ = stereo_runs["c64"]
    sep_l, sep_r = separation_db(yt, 900.0, 2500.0)
    assert sep_l > 30.0 and sep_r > 30.0, (sep_l, sep_r)


@pytest.mark.parametrize("fmt", ["i16", "u8"])
def test_stereo_wire_matches_converted(stereo_runs, fmt):
    """tests/test_chains.py:270-310: raw wire blocks against the c64 chain
    on the dequantized samples, > 80 dB past the first tenth."""
    _, (yw, _), xc = stereo_runs[fmt]
    yc, _ = _port_stereo(_blocks(xc, 4))
    s0 = len(yc) // 10
    assert snr_db(yc[s0:], yw[s0:]) > 80.0
    with pytest.raises(TypeError):
        twbfm.WBFMStereoReceiver(block_len=N, input_format=fmt, device="cpu")(xc[:N])


def test_audio_decimator_uniform_sampling():
    """tests/test_chains.py:114-138 on the port's two-phase decimator: a
    5 kHz tone lands on the uniform 48 kHz grid (odd outputs at 25j +
    12.5), > 60 dB."""
    rx = twbfm.WBFMStereoReceiver(device="cpu")
    h2 = rx._params.h2
    comp_rate = 600000.0
    f = 5000.0 / comp_rate
    x = torch.from_numpy(np.cos(2 * np.pi * f * np.arange(200_000)).astype(np.float32))
    _, y = twbfm._dec_audio(h2, 25, torch.zeros((1, 0)), x[None])
    y = y[0].numpy()[400:-400]
    k = np.arange(len(y)) + 400
    ref = np.exp(2j * np.pi * f * 12.5 * k)
    a = np.vdot(ref, y + 0j) / np.vdot(ref, ref)
    resid = y - 2 * (a * ref).real
    assert 10 * np.log10(np.mean(y ** 2) / np.mean(resid ** 2)) > 60.0


def test_stereo_from_jax_carries_the_stream():
    """tpudsp runs two blocks, convert.stereo_from_jax carries its params
    and state over, the port runs the third: >= 80 dB per channel against
    tpudsp's third."""
    x = _stereo_iq(3 * N).astype(np.complex64)
    _, jr = _jax_stereo(_blocks(x, 2))
    params, state = convert.stereo_from_jax(jr._params, jr.state, device="cpu")
    assert isinstance(params.dtheta_u, int) and state.pilot.phase_u.dtype == torch.int64
    y3j = np.asarray(jr(x[2 * N:]))
    _, (y3t, _) = twbfm._stereo_step(params, state, torch.from_numpy(x[2 * N:]),
                                     cfg=twbfm.StereoConfig())
    for c in range(2):
        assert snr_db(y3j[:, c], y3t.numpy()[:, c]) >= 80.0


def test_stereo_rules():
    with pytest.raises(ValueError):
        twbfm.WBFMStereoReceiver(block_len=N + 1, device="cpu")
    with pytest.raises(ValueError):
        twbfm.WBFMStereoReceiver(block_len=N, input_format="f32", device="cpu")
    rx = twbfm.WBFMStereoReceiver(block_len=N, device="cpu")
    with pytest.raises(ValueError):
        rx(np.zeros(N // 2, np.complex64))
