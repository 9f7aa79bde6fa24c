"""The port's SSB receiver (``tpudsp_torch.chains.ssb``, on the CPU: the
AGC kernel's plain versions) against tpudsp's on the same numpy-seeded
input, over blocks of 50,000 samples, chunked and exact (>= 80 dB):
at a 480 ksps config whose 5000 pcm samples a block take the chunked
AGC's lanes and its padded-tail fix, and at the default 2 Msps config
(1200 pcm samples a block: both routes run the exact scan there). Also
the JAX package's sideband-rejection pin (> 30 dB,
tests/test_chains.py:177-207) and ``convert.ssb_from_jax``."""

import numpy as np
import pytest
import torch

from tests.util import snr_db
from tpudsp.chains import ssb as jssb
from tpudsp_torch import convert
from tpudsp_torch.chains import ssb as tssb

N = 50_000
SMALL = dict(iq_rate=480_000.0, agc_bandwidth=0.05)


def _usb_voice(n, rate, amp=0.3):
    """A USB-only message (800 Hz and 1900 Hz) as the analytic signal."""
    import scipy.signal as sig
    t = np.arange(n)
    m = np.sin(2 * np.pi * 800.0 / rate * t) + 0.5 * np.sin(2 * np.pi * 1900.0 / rate * t)
    return (amp * sig.hilbert(m) / 2).astype(np.complex64)


def _runs(cfg_kw, exact, x, nblocks, band="usb"):
    jr = jssb.SSBReceiver(jssb.SSBConfig(band=band, **cfg_kw), block_len=N, exact=exact)
    tr = tssb.SSBReceiver(tssb.SSBConfig(band=band, **cfg_kw), block_len=N, exact=exact,
                          device="cpu")
    blocks = [x[k * N:(k + 1) * N] for k in range(nblocks)]
    yj = np.concatenate([np.asarray(jr(b)) for b in blocks])
    yt = torch.cat([tr(torch.from_numpy(b)) for b in blocks]).numpy()
    return yj, yt, jr, tr


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("cfg_kw", [SMALL, {}], ids=["480k", "default"])
def test_ssb_receiver_matches_tpudsp(cfg_kw, exact):
    rate = cfg_kw.get("iq_rate", 2e6)
    noise = np.random.default_rng(3).standard_normal((2 * N, 2)) @ [1, 1j]
    x = (_usb_voice(2 * N, rate) + 0.002 * noise).astype(np.complex64)
    yj, yt, jr, tr = _runs(cfg_kw, exact, x, 2)
    assert yt.shape == yj.shape == (2 * tr.n_out,) and yt.dtype == np.float32
    assert snr_db(yj[100:], yt[100:]) >= 80.0
    m = tr.metrics
    assert m.squelch_modes.shape == (tr.n_out,) and torch.all(m.squelch_modes == 7)
    assert abs(float(m.rssi) - float(jr.metrics.rssi)) < 1e-3


def test_ssb_receiver_rejects_the_other_sideband():
    """A USB voice signal through usb and lsb receivers: the lsb one's
    power > 30 dB below (the settled second half)."""
    x = _usb_voice(4 * N, 2e6)
    _, usb, _, _ = _runs({}, False, x, 4, "usb")
    _, lsb, _, _ = _runs({}, False, x, 4, "lsb")
    h = len(usb) // 2
    assert 10 * np.log10(np.mean(usb[h:] ** 2) / np.mean(lsb[h:] ** 2)) > 30.0


@pytest.mark.parametrize("exact", [False, True])
def test_ssb_from_jax_carries_the_stream(exact):
    """tpudsp runs two blocks, convert.ssb_from_jax carries its params and
    state over, the port runs the third: >= 80 dB against tpudsp's third."""
    x = _usb_voice(3 * N, SMALL["iq_rate"])
    jr = jssb.SSBReceiver(jssb.SSBConfig(**SMALL), block_len=N, exact=exact)
    for k in range(2):
        jr(x[k * N:(k + 1) * N])
    params, state = convert.ssb_from_jax(jr.params, jr.state, device="cpu")
    y3j = np.asarray(jr(x[2 * N:]))
    cfg = tssb.SSBConfig(**SMALL)
    _, (y3t, _) = tssb.ssb_step(params, state, torch.from_numpy(x[2 * N:]), cfg=cfg,
                                n_out=jr.n_out, exact=exact)
    assert snr_db(y3j, y3t.numpy()) >= 80.0


def test_ssb_build_matches_tpudsp():
    """Every design array of the port's build equals tpudsp's bit for bit."""
    jp, js, jn = jssb.build(jssb.SSBConfig(), N)
    tp, ts, tn = tssb.build(tssb.SSBConfig(), N, device="cpu")
    assert tn == jn
    for a, b in ((tp.taps_fused, jp.taps_fused), (tp.h_hilb, jp.h_hilb),
                 (ts.rs_tail, js.rs_tail)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tssb.build(tssb.SSBConfig(), N + 1, device="cpu")
