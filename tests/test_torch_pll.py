"""The port's carrier-PLL scans (the plain versions of csrc/pll_scan.cu)
against tpudsp's lax.scan ``pll_carrier_scan`` and its chunked form, on
the same AM signal made with numpy (carrier offset 0.0005 cycles/sample,
phase 0.5 rad). Bars: the per-sample theta within 1e-4 rad of tpudsp's
(wrapped difference) and the final theta / freq within 1e-4 rad and 1e-6
rad/sample. Measured on the CPU: theta within 7.7e-6 rad, freq within
2.4e-9 rad/sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudsp.kernels import pll as jpll
from tpudsp_torch.cuda import pll_scan
from tpudsp_torch.kernels import lanes
from tpudsp_torch.kernels import pll as tpll

BW = 0.001


def _signal(n):
    t = np.arange(n)
    m = np.sin(2 * np.pi * 0.01 * t)
    return ((1.0 + 0.5 * m) * np.exp(2j * np.pi * 0.0005 * t + 0.5j)
            ).astype(np.complex64)


def _dtheta(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64)
                                        - np.asarray(b, np.float64)))))


def _compare(jres, tres):
    (jst, jth), (tst, tth) = jres, tres
    assert tth.shape == jth.shape and tth.dtype == torch.float32
    assert np.max(_dtheta(jth, tth.numpy())) < 1e-4
    assert _dtheta(jst.theta, tst.theta.numpy()) < 1e-4
    assert abs(float(jst.freq) - float(tst.freq)) < 1e-6


def _states():
    return jpll.pll_init(), tpll.pll_init()


def test_pll_carrier_scan_matches_tpudsp():
    x = _signal(6000)
    js, ts = _states()
    _compare(jpll.pll_carrier_scan(js, jnp.asarray(x), BW),
             tpll.pll_carrier_scan(ts, torch.from_numpy(x), BW))


@pytest.mark.parametrize("n", [20_000, 3000])   # chunked + ragged; short
def test_pll_carrier_scan_chunked_matches_tpudsp(n):
    x = _signal(n)
    js, ts = _states()
    _compare(jpll.pll_carrier_scan_chunked(js, jnp.asarray(x), BW),
             tpll.pll_carrier_scan_chunked(ts, torch.from_numpy(x), BW))


def test_wrappers_take_the_plain_version_on_cpu():
    x = torch.from_numpy(_signal(20_000))
    _, ts = _states()
    ref = tpll.pll_carrier_scan_chunked(ts, x, BW)
    st, th = pll_scan.pll_carrier_scan_chunked(lanes.one_stream(ts), x[None], BW)
    assert torch.equal(th[0], ref[1])
    assert all(torch.equal(a[0], b) for a, b in zip(st, ref[0]))
    st, th = pll_scan.pll_carrier_scan(lanes.one_stream(ts), x[None, :500], BW)
    assert torch.equal(th[0], tpll.pll_carrier_scan(ts, x[:500], BW)[1])
    assert pll_scan._launch.launches == 0
