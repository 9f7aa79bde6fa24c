"""The port's AM receiver with the JAX receiver's other options, on the CPU
(the kernels' plain versions) against ``tpudsp``'s receiver with the same
options, over two consecutive 250k-sample blocks (n_out = 6000 per block):

- ``plan='composed'`` (overlap-save bandpass, resampler, the fused-kernel
  back end) against tpudsp's composed plan with its Pallas back end
  (interpret mode), whose linear tail is the plain f32 associative scan:
  >= 80 dB, the bar of the fused plan's pin against it (measured 102.6
  dB);
- ``exact=True`` (no backend: the XLA back end on both sides) and
  ``backend='xla'`` against tpudsp's XLA back end with the same ``exact``: >= 100 dB (measured 112.9 dB each);
- every option >= 100 dB against the float64 oracle chain (measured
  119.7-120.4 dB);
- fused equals composed at exact=True, as tpudsp's own
  test_am_receiver_fused_equals_composed sets it up (>= 70 dB);
- a rate with no small rational form takes the composed plan, as in
  tpudsp;
- the back-end rules: 'pallas' names the fused-kernel back end, which
  refuses exact=True; exact=True with no backend takes 'xla', as tpudsp's
  default does; raw wire formats need the fused plan.
"""

import numpy as np
import pytest
import torch

from tests.test_chain_snr import oracle_am_chain
from tests.util import snr_db
from tpudsp.chains import am as jam
from tpudsp_torch.chains import am as tam

N = 500_000
BLOCK = N // 2
SETTLE = N * 48 // 2_000 // 2    # the second half of the pcm
OPTIONS = {
    "composed": (dict(plan="composed"), dict(plan="composed", backend="pallas"), 80.0),
    "exact": (dict(exact=True), dict(exact=True), 100.0),
    "xla": (dict(backend="xla"), dict(backend="xla"), 100.0),
}


def _iq(n=N, iq_rate=2e6):
    t = np.arange(n)
    msg = np.sin(2 * np.pi * 1000.0 / iq_rate * t)
    return ((1.0 + 0.5 * msg) * 0.3
            * np.exp(2j * np.pi * 200.0 / iq_rate * t)).astype(np.complex64)


def _port(cfg, block, iq, **kw):
    rx = tam.AMReceiver(cfg, block, device="cpu", **kw)
    return rx, torch.cat([rx(torch.from_numpy(iq[k:k + block]))
                          for k in range(0, len(iq), block)]).numpy()


def _jax(cfg, block, iq, **kw):
    rx = jam.AMReceiver(cfg, block_len=block, **kw)
    return rx, np.concatenate([np.asarray(rx(iq[k:k + block]))
                               for k in range(0, len(iq), block)])


@pytest.fixture(scope="module")
def oracle():
    return oracle_am_chain(_iq().astype(np.complex128), jam.AMConfig())


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_receiver_option_matches_tpudsp(option, oracle):
    port_kw, jax_kw, bar = OPTIONS[option]
    iq = _iq()
    rx, yt = _port(tam.AMConfig(), BLOCK, iq, **port_kw)
    _, yj = _jax(jam.AMConfig(), BLOCK, iq, **jax_kw)
    assert yt.shape == yj.shape == (2 * rx.n_out,) and yt.dtype == np.float32
    s = snr_db(yj[SETTLE:], yt[SETTLE:])
    assert s > bar, f"vs tpudsp {s:.1f} dB"
    s = snr_db(oracle[SETTLE:], yt[SETTLE:])
    assert s > 100.0, f"vs oracle {s:.1f} dB"
    m = rx.metrics
    assert m.squelch_modes.shape == (rx.n_out,) and torch.all(m.squelch_modes == 7)
    assert abs(float(m.pll_freq) - 2 * np.pi * 200 / 48_000) < 1e-4


def test_fused_equals_composed_exact():
    """tpudsp's test_am_receiver_fused_equals_composed on the port: one
    250k-sample block, exact scans, >= 70 dB past the first 200 samples."""
    iq = _iq(BLOCK)
    rx_f, y_f = _port(tam.AMConfig(), BLOCK, iq, plan="fused", exact=True, backend="xla")
    rx_c, y_c = _port(tam.AMConfig(), BLOCK, iq, plan="composed", exact=True, backend="xla")
    assert rx_f.plan == "fused" and rx_c.plan == "composed"
    assert y_f.shape == y_c.shape == (rx_f.n_out,)
    assert snr_db(y_c[200:], y_f[200:]) > 70.0


def test_irrational_rate_takes_the_composed_plan():
    """12,000 / 500,003 has no rational form with a denominator <= 10,000:
    both receivers take the composed plan; >= 80 dB against tpudsp's (the
    fused-kernel back end against its Pallas one)."""
    cfg_t = tam.AMConfig(iq_rate=500_003.0, pcm_rate=12_000.0)
    cfg_j = jam.AMConfig(iq_rate=500_003.0, pcm_rate=12_000.0)
    iq = _iq(2 * 500_003, iq_rate=500_003.0)
    rx, yt = _port(cfg_t, 500_003, iq)
    jr, yj = _jax(cfg_j, 500_003, iq, backend="pallas")
    assert rx.plan == jr.plan == "composed" and rx.n_out == 12_000
    assert yt.shape == yj.shape and np.all(np.isfinite(yt))
    assert snr_db(yj[12_000:], yt[12_000:]) > 80.0


def test_back_end_rules():
    cfg = tam.AMConfig()
    iq = torch.from_numpy(_iq(50_000))
    y_kernel = tam.AMReceiver(cfg, 50_000, device="cpu")(iq)
    y_pallas = tam.AMReceiver(cfg, 50_000, device="cpu", backend="pallas")(iq)
    assert torch.equal(y_kernel, y_pallas)
    # exact=True with no backend is the XLA back end, as tpudsp's default
    rx_exact = tam.AMReceiver(cfg, 50_000, device="cpu", exact=True)
    assert rx_exact.backend == "xla"
    y_exact = tam.AMReceiver(cfg, 50_000, device="cpu", exact=True, backend="xla")(iq)
    assert torch.equal(rx_exact(iq), y_exact)
    for backend in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="exact=False"):
            tam.AMReceiver(cfg, 50_000, device="cpu", exact=True, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        tam.AMReceiver(cfg, 50_000, device="cpu", backend="mosaic")
    with pytest.raises(ValueError, match="unknown plan"):
        tam.AMReceiver(cfg, 50_000, device="cpu", plan="split")
    with pytest.raises(ValueError, match="fused plan"):
        tam.AMReceiver(cfg, 50_000, "i16", device="cpu", plan="composed")
