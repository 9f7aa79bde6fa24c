"""The fused AM back end of the port against tpudsp's.

- ``front_chunked_ref`` (the CUDA kernel's plain version) against the
  Pallas kernel ``front_chunked_pallas`` in interpret mode: same lanes,
  same warmup windows, same patan2. >= 80 dB on vr with equal modes.
- ``front_exact`` against a lax.scan of tpudsp's front_sample_step with
  patan2 (the Pallas kernel's step).
- The short-block path (N <= chunk + warmup) against ``am_backend_exact``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import snr_db
from tpudsp.kernels import agc as jagc
from tpudsp.kernels import am_backend as jab
from tpudsp.kernels.fastmath import patan2 as jpatan2
from tpudsp.pallas.am_backend_scan import front_chunked_pallas
from tpudsp_torch.cuda import am_backend_scan as tscan
from tpudsp_torch.kernels import agc as tagc
from tpudsp_torch.kernels import am_backend as tab

DEEMPH = (0.05, 0.95)


def _signal(n, carrier_freq=0.002, amp=0.3, msg_freq=0.02):
    t = np.arange(n)
    m = np.sin(2 * np.pi * msg_freq * t)
    return ((1 + 0.5 * m) * amp
            * np.exp(2j * np.pi * carrier_freq * t)).astype(np.complex64)


def _params(squelch=False, threshold=0.0):
    kw = dict(alpha=0.01, scale=0.01, squelch=squelch, threshold=threshold)
    jp = jab.make_params(jagc.make_params(**kw), 0.5, *DEEMPH, carrier=True)
    tp = tab.make_params(tagc.make_params(**kw), 0.5, *DEEMPH, carrier=True)
    return jp, tp


def _states(C, squelch=False):
    """The same initial front state as (JAX, port), leaves shaped (C,)."""
    j0 = jagc.agc_init(squelch=squelch)
    jst = jab.FrontState(
        jax.tree.map(lambda v: jnp.broadcast_to(v, (C,)), j0),
        jab.PllState(jnp.zeros((C,), jnp.float32), jnp.zeros((C,), jnp.float32)))
    t0 = tagc.agc_init(squelch=squelch)
    tst = tab.FrontState(
        tagc.AgcState(*(v.expand(C).clone() for v in t0)),
        tab.PllState(torch.zeros(C), torch.zeros(C)))
    return jst, tst


def _theta_close(a, b, atol):
    d = np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b, np.float64))))
    assert np.max(np.abs(d)) < atol, d


def _compare_front(jfront, jvr, jmodes, tfront, tvr, tmodes, bar):
    for c in range(jvr.shape[0]):
        s = snr_db(np.asarray(jvr)[c], tvr[c].numpy())
        assert s > bar, f"stream {c}: {s:.1f} dB"
    np.testing.assert_array_equal(tmodes.numpy(), np.asarray(jmodes))
    np.testing.assert_allclose(tfront.agc.g.numpy(), np.asarray(jfront.agc.g), rtol=1e-4)
    np.testing.assert_array_equal(tfront.agc.sq_mode.numpy(), np.asarray(jfront.agc.sq_mode))
    np.testing.assert_array_equal(tfront.agc.sq_timer.numpy(), np.asarray(jfront.agc.sq_timer))
    # a squelched stream's PLL free-runs on zeros (its phase is not
    # observable), so the loop state is compared on live streams only
    live = ~np.isin(np.asarray(jfront.agc.sq_mode), [1, 5])
    _theta_close(tfront.pll.theta.numpy()[live], np.asarray(jfront.pll.theta)[live], 1e-3)
    np.testing.assert_allclose(tfront.pll.freq.numpy()[live],
                               np.asarray(jfront.pll.freq)[live], atol=1e-5)


def test_front_chunked_ref_matches_pallas_single_stream():
    """C = 1 at a length that pads the last chunk (the tail fix runs)."""
    x = _signal(12_000)[None]
    jp, tp = _params()
    jst, tst = _states(1)
    jf, (jvr, jm) = front_chunked_pallas(jp, jst, jnp.asarray(x), chunk=1024,
                                         warmup=2048, interpret=True)
    tf, (tvr, tm) = tscan.front_chunked_ref(tp, tst, torch.from_numpy(x), 1024, 2048)
    assert tvr.shape == (1, 12_000) and tm.dtype == torch.int32
    _compare_front(jf, jvr, jm, tf, tvr, tm, 80.0)


def test_front_chunked_ref_matches_pallas_batched_squelch():
    """C = 3, ragged L, distinct carriers and levels, squelch on: stream 0
    stays loud, stream 1 stays quiet, stream 2 drops out half way. The
    settled rssi levels (about -10 and -60 dB) sit far from the -35 dB
    threshold, so the modes must agree sample for sample."""
    L = 9_000 - 77
    xs = np.stack([_signal(L, 0.001, 0.3), _signal(L, 0.002, 0.001),
                   _signal(L, 0.003, 0.3)])
    xs[2, L // 2:] *= 0.003
    jp, tp = _params(squelch=True, threshold=-35.0)
    jst, tst = _states(3, squelch=True)
    jf, (jvr, jm) = front_chunked_pallas(jp, jst, jnp.asarray(xs), chunk=1024,
                                         warmup=2048, interpret=True)
    tf, (tvr, tm) = tscan.front_chunked_ref(tp, tst, torch.from_numpy(xs), 1024, 2048)
    # every squelch state the stream-2 drop-out walks through appears
    assert {1, 2, 3, 4, 5, 6} <= set(np.unique(tm[2].numpy()))
    _compare_front(jf, jvr, jm, tf, tvr, tm, 80.0)


def test_front_chunked_dispatches_to_ref_on_cpu():
    x = torch.from_numpy(np.stack([_signal(5_000, 0.001), _signal(5_000, 0.004)]))
    _, tp = _params()
    _, tst = _states(2)
    before = tscan._launch.launches
    a = tscan.front_chunked(tp, tst, x, 1024, 1024)
    b = tscan.front_chunked_ref(tp, tst, x, 1024, 1024)
    for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(u, v)
    assert tscan._launch.launches == before


def test_front_exact_matches_pallas_step():
    """The plain sequential front against a lax.scan of tpudsp's
    front_sample_step with patan2, over 6000 samples."""
    x = _signal(6_000, 0.004)
    jp, tp = _params()
    j0, t0 = jab.FrontState(jagc.agc_init(), jab.PllState(jnp.float32(0), jnp.float32(0))), \
        tab.FrontState(tagc.agc_init(), tab.PllState(torch.tensor(0.0), torch.tensor(0.0)))
    step = partial(jab.front_sample_step, atan2=jpatan2)
    jf, (jvr, jm) = jax.lax.scan(
        lambda s, xn: step(jp, s, xn.real, xn.imag), j0, jnp.asarray(x))
    tf, (tvr, tm) = tab.front_exact(tp, t0, torch.from_numpy(x))
    s = snr_db(np.asarray(jvr), tvr.numpy())
    assert s > 100.0, f"{s:.1f} dB"
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _theta_close(tf.pll.theta.numpy(), jf.pll.theta, 1e-4)


def test_front_chunked_1d_matches_xla_twin():
    """kernels/am_backend.front_chunked (one stream) against tpudsp's XLA
    chunked front, which uses libm atan2: >= 80 dB after settling."""
    x = _signal(14_000, 0.003)
    jp, tp = _params()
    j0 = jab.FrontState(jagc.agc_init(), jab.PllState(jnp.float32(0), jnp.float32(0)))
    t0 = tab.FrontState(tagc.agc_init(), tab.PllState(torch.tensor(0.0), torch.tensor(0.0)))
    jf, (jvr, _) = jab.front_chunked(jp, j0, jnp.asarray(x), chunk=1024, warmup=2048)
    tf, (tvr, tm) = tab.front_chunked(tp, t0, torch.from_numpy(x), 1024, 2048)
    assert tvr.shape == (14_000,) and tf.agc.g.shape == ()
    s = snr_db(np.asarray(jvr)[2000:], tvr.numpy()[2000:])
    assert s > 80.0, f"{s:.1f} dB"


@pytest.mark.parametrize("n", [3_000, 1_000])
def test_short_block_matches_am_backend_exact(n):
    """N <= chunk + warmup: the front runs exactly, then the blocked linear
    tail; tpudsp runs its serial am_backend_exact (libm atan2, f32 serial
    one-poles). >= 80 dB after the PLL settles, equal modes and carried
    DC / de-emphasis state."""
    x = _signal(n, 0.002)
    jp, tp = _params()
    jst = jab.init_state()
    tst = tab.init_state()
    jf, (jpcm, jm) = jab.am_backend_exact(jp, jst, jnp.asarray(x))
    tf, (tpcm, tm) = tscan.am_backend_chunked(tp, tst, torch.from_numpy(x), 1024, warmup=2048)
    assert tpcm.shape == (n,)
    s = snr_db(np.asarray(jpcm)[n // 3:], tpcm.numpy()[n // 3:])
    assert s > 80.0, f"{s:.1f} dB"
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(float(tf.dc), float(jf.dc), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tf.deemph), float(jf.deemph), rtol=1e-4, atol=1e-6)


def test_am_backend_exact_matches_tpudsp():
    """The port's serial combined back end against tpudsp's (both f32
    serial; patan2 against libm atan2 is the only modelled difference)."""
    x = _signal(2_000, 0.001)
    jp, tp = _params()
    _, (jpcm, jm) = jab.am_backend_exact(jp, jab.init_state(), jnp.asarray(x))
    _, (tpcm, tm) = tab.am_backend_exact(tp, tab.init_state(), torch.from_numpy(x))
    s = snr_db(np.asarray(jpcm)[500:], tpcm.numpy()[500:])
    assert s > 80.0, f"{s:.1f} dB"
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_kernel_launch_refuses_non_cuda_tensors():
    """The launch path never falls back to the plain version: tensors that
    are not on a CUDA device are refused, and nothing is counted."""
    _, tp = _params()
    _, tst = _states(1)
    planes = torch.zeros((1024, 3))
    before = tscan._launch.launches
    with pytest.raises(ValueError, match="CUDA"):
        tscan._launch(tp, tst, planes, planes, 3, 512)
    assert tscan._launch.launches == before
