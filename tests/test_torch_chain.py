"""The port's fused AM receiver (CPU, the kernel's plain version) over two
consecutive 500k-sample blocks (n_out = 12000 per block, so the chunked
front runs) against the float64 oracle chain and tpudsp's receivers, and
``convert.from_jax`` against the port's own ``build``."""

import numpy as np
import pytest
import torch

from tests.test_chain_snr import oracle_am_chain
from tests.util import snr_db
from tpudsp.chains import am as jam
from tpudsp_torch import convert
from tpudsp_torch.chains import am as tam
from tpudsp_torch.cuda import am_backend_scan as tscan

N = 1_000_000
BLOCK = N // 2
SETTLE = N * 48 // 2_000 // 2    # the second half of the pcm


def _iq():
    t = np.arange(N)
    msg = np.sin(2 * np.pi * 1000.0 / 2e6 * t)
    return ((1.0 + 0.5 * msg) * 0.3
            * np.exp(2j * np.pi * 200.0 / 2e6 * t)).astype(np.complex64)


@pytest.fixture(scope="module")
def outputs():
    iq = _iq()
    out = {"oracle": oracle_am_chain(iq.astype(np.complex128), jam.AMConfig())}
    rx = tam.AMReceiver(tam.AMConfig(), BLOCK, device="cpu")
    out["port"] = torch.cat([rx(torch.from_numpy(iq[:BLOCK])),
                             rx(torch.from_numpy(iq[BLOCK:]))]).numpy()
    out["port_metrics"] = rx.metrics
    for backend in ("pallas", "xla"):
        jr = jam.AMReceiver(jam.AMConfig(), block_len=BLOCK, backend=backend)
        out[backend] = np.concatenate([np.asarray(jr(iq[:BLOCK])),
                                       np.asarray(jr(iq[BLOCK:]))])
    return out


def test_port_chain_vs_oracle(outputs):
    """>= 100 dB, the JAX package's own chain pin (measured ~120 dB)."""
    y = outputs["port"]
    assert y.shape == outputs["oracle"].shape and y.dtype == np.float32
    s = snr_db(outputs["oracle"][SETTLE:], y[SETTLE:])
    assert s > 100.0, f"{s:.1f} dB"


def test_port_chain_vs_tpudsp_pallas_backend(outputs):
    """>= 80 dB against AMReceiver(backend='pallas'), whose linear tail is
    the plain f32 associative scan and whose chunk is 1024."""
    s = snr_db(outputs["pallas"][SETTLE:], outputs["port"][SETTLE:])
    assert s > 80.0, f"{s:.1f} dB"


def test_port_chain_vs_tpudsp_xla_backend(outputs):
    """>= 65 dB against the default XLA back end (separate AGC and PLL
    chunked scans, libm atan2)."""
    s = snr_db(outputs["xla"][SETTLE:], outputs["port"][SETTLE:])
    assert s > 65.0, f"{s:.1f} dB"


def test_port_chain_metrics(outputs):
    m = outputs["port_metrics"]
    assert m.squelch_modes.shape == (BLOCK * 48 // 2_000,)
    assert torch.all(m.squelch_modes == 7)   # squelch off: DISABLED
    # the recovered carrier: 200 Hz at 48 kHz in rad/sample
    assert abs(float(m.pll_freq) - 2 * np.pi * 200 / 48_000) < 1e-4
    assert np.isfinite(float(m.rssi)) and float(m.resamp_credit) == 0.0


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_from_jax_reproduces_build(fmt):
    """Every design array the port builds equals the JAX package's bit for
    bit, and from_jax carries params and state over leaf for leaf."""
    block = 250_000
    jp, js, _ = jam.build(jam.AMConfig(), block, fmt)
    tp, ts, _ = tam.build(tam.AMConfig(), block, fmt, device="cpu")
    cp, cs = convert.from_jax(jp, js, device="cpu")
    for tree_port, tree_conv in ((tp, cp), (ts, cs)):
        leaves_p = _leaves(tree_port)
        leaves_c = _leaves(tree_conv)
        assert [k for k, _ in leaves_p] == [k for k, _ in leaves_c]
        for (k, a), (_, b) in zip(leaves_p, leaves_c):
            if a is None:
                assert b is None, k
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(a, b), k


def _leaves(tree, prefix=""):
    out = []
    for f, v in zip(tree._fields, tree):
        if isinstance(v, tuple):
            out += _leaves(v, f"{prefix}{f}.")
        else:
            out.append((prefix + f, v))
    return out


def test_squelch_events_match_tpudsp():
    from tpudsp.chains.metrics import squelch_events as jevents
    from tpudsp_torch.chains.metrics import squelch_events as tevents
    rng = np.random.default_rng(4)
    modes = rng.integers(0, 8, size=(3, 400)).astype(np.int32)
    assert tevents(torch.from_numpy(modes)) == jevents(modes)
    assert tevents(torch.from_numpy(modes[1])) == jevents(modes[1])


def test_receiver_launches_no_kernel_on_cpu(outputs):
    assert tscan._launch.launches == 0
