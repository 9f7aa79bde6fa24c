"""The staged scan kernels csrc/am_front_scan.cu and csrc/agc_scan.cu off
the card: their plain versions at the shapes where the kernels' staging
could go wrong -- a chunk that the stage depth (64) does not divide or that
is shorter than a stage, a warmup of several chunks and a fraction (stages
cross chunk boundaries inside the warmup), a ragged last chunk with the
squelch on, lane counts that are no multiple of 32, the sharded receiver's
single-lane entry scan from a carried state, and PLL states and gains that
take the front kernel's unbounded PLL instance (theta outside [-pi, pi],
the wrap's argument outside (-2 pi, 4 pi)) -- against tpudsp's
``front_chunked_pallas(interpret=True)``, ``agc_chunked_pallas(interpret=
True)`` and ``agc_apply_chunked`` on the CPU, at the bars of
tests/test_torch_am_backend.py and test_torch_agc.py.

On the card, chip_smoke.py holds each kernel against these plain versions
bit for bit at the same kinds of shapes.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_am_backend import _compare_front, _params, _signal, _states
from tests.util import snr_db
from tpudsp.kernels import agc as jagc
from tpudsp.kernels import am_backend as jab
from tpudsp.kernels.fastmath import patan2 as jpatan2
from tpudsp.pallas.agc_scan import agc_chunked_pallas
from tpudsp.pallas.am_backend_scan import front_chunked_pallas
from tpudsp_torch.cuda import agc_scan
from tpudsp_torch.cuda import am_backend_scan as tscan
from tpudsp_torch.kernels import agc as tagc
from tpudsp_torch.kernels import am_backend as tab


# ------------------------------------------- plain versions at edge shapes

def _squelch_batch(L):
    """Three streams, squelch on: loud, quiet, and loud dropping out half
    way (test_torch_am_backend's batch)."""
    xs = np.stack([_signal(L, 0.001, 0.3), _signal(L, 0.002, 0.001),
                   _signal(L, 0.003, 0.3)])
    xs[2, L // 2:] *= 0.003
    return xs


@pytest.mark.parametrize("L, chunk, warmup", [
    # chunk 1000 (no multiple of the stage depth 64), warmup 2.5 chunks,
    # 18 lanes, ragged last chunk
    (6_000 - 77, 1000, 2500),
    # chunk 700, warmup 3000 (4.3 chunks), 30 lanes
    (7_000 - 13, 700, 3000),
    # chunk 50, shorter than a stage: every stage crosses a chunk boundary,
    # warmup 1030 (20.6 chunks), 3 x 120 lanes
    (6_000 - 11, 50, 1030),
])
def test_front_plain_matches_pallas_at_staging_edges(L, chunk, warmup):
    xs = _squelch_batch(L)
    assert (3 * -(-L // chunk)) % 32 and L % chunk and warmup % chunk
    jp, tp = _params(squelch=True, threshold=-35.0)
    jst, tst = _states(3, squelch=True)
    jf, (jvr, jm) = front_chunked_pallas(jp, jst, jnp.asarray(xs), chunk=chunk,
                                         warmup=warmup, interpret=True)
    tf, (tvr, tm) = tscan.front_chunked_ref(tp, tst, torch.from_numpy(xs), chunk,
                                            warmup)
    assert {1, 2, 3, 4, 5} <= set(np.unique(tm[2].numpy()))
    _compare_front(jf, jvr, jm, tf, tvr, tm, 80.0)


def test_entry_scan_from_carried_state_matches_pallas_step():
    """The sharded receiver's entry scan: the exact front over 3840
    samples, from a state carried out of an earlier block rather than the
    initial one, against a lax.scan of tpudsp's front_sample_step with
    patan2."""
    x = _signal(3840 + 2000, 0.004)
    jp, tp = _params()
    step = partial(jab.front_sample_step, atan2=jpatan2)
    scan = lambda s, xs: jax.lax.scan(lambda c, xn: step(jp, c, xn.real, xn.imag), s, xs)
    j0 = jab.FrontState(jagc.agc_init(), jab.PllState(jnp.float32(0), jnp.float32(0)))
    jcarried, _ = scan(j0, jnp.asarray(x[:2000]))
    jf, (jvr, jm) = scan(jcarried, jnp.asarray(x[2000:]))
    leaves = [torch.tensor(np.asarray(v)).reshape(1) for v in jax.tree.leaves(jcarried)]
    tcarried = tab.FrontState(tagc.AgcState(*leaves[:4]), tab.PllState(*leaves[4:]))
    tf, (tvr, tm) = tscan.front_exact(tp, tcarried, torch.from_numpy(x[None, 2000:]))
    s = snr_db(np.asarray(jvr), tvr[0].numpy())
    assert s > 100.0, f"{s:.1f} dB"
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
    np.testing.assert_allclose(tf.agc.g.numpy(), [float(jf.agc.g)], rtol=1e-4)


@pytest.mark.parametrize("pll_bw", [0.001, 0.05])
def test_front_plain_matches_pallas_from_unbounded_pll_states(pll_bw):
    """Stream 1 starts at theta = 20 (the wrap's floor-mod runs its fmodf
    path on the first step), stream 2 at theta = -7 and freq = 0.05; at a
    loop gain of 0.05 no stage of the front kernel's PLL warp is bounded."""
    L, chunk, warmup = 6_000 - 77, 1000, 2500
    xs = np.stack([_signal(L, 0.001), _signal(L, 0.002), _signal(L, 0.003)])
    kw = dict(alpha=0.01, scale=0.01)
    jp = jab.make_params(jagc.make_params(**kw), 0.5, 0.05, 0.95, carrier=True,
                         pll_bw=pll_bw)
    tp = tab.make_params(tagc.make_params(**kw), 0.5, 0.05, 0.95, carrier=True,
                         pll_bw=pll_bw)
    jst, tst = _states(3)
    theta, freq = np.float32([0.0, 20.0, -7.0]), np.float32([0.0, 0.0, 0.05])
    jst = jst._replace(pll=jab.PllState(jnp.asarray(theta), jnp.asarray(freq)))
    tst = tst._replace(pll=tab.PllState(torch.from_numpy(theta), torch.from_numpy(freq)))
    jf, (jvr, jm) = front_chunked_pallas(jp, jst, jnp.asarray(xs), chunk=chunk,
                                         warmup=warmup, interpret=True)
    tf, (tvr, tm) = tscan.front_chunked_ref(tp, tst, torch.from_numpy(xs), chunk,
                                            warmup)
    _compare_front(jf, jvr, jm, tf, tvr, tm, 80.0)


def _gated(n, start, stop):
    """Loud between samples start and stop, -80 dB elsewhere."""
    t = np.arange(n)
    amp = np.where((t > start) & (t < stop), 1.0, 1e-4)
    return (np.exp(2j * np.pi * 0.02 * t) * amp).astype(np.complex64)


def _agc_compare(jres, tres):
    """test_torch_agc's bars, per stream."""
    (jst, (jy, jm)), (tst, (ty, tm)) = jres, tres
    jy = np.asarray(jy)
    assert ty.shape == jy.shape
    s = snr_db(jy, ty.numpy())
    assert s >= 100.0, f"{s:.1f} dB"
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for f in ("g", "y2p"):
        np.testing.assert_allclose(float(getattr(tst, f)), float(getattr(jst, f)),
                                   rtol=1e-5)
    assert int(tst.sq_mode) == int(jst.sq_mode)
    assert int(tst.sq_timer) == int(jst.sq_timer)


@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_agc_plain_matches_tpudsp_at_staging_edges(route):
    """Chunk 1000 (no multiple of the stage depth), warmup 3750 = 3.75
    chunks, three streams of a ragged length (8 chunks each: 24 lanes),
    squelch on, each stream gated at its own time: the port's batched plain
    version against tpudsp stream by stream."""
    L, chunk, warmup = 8_000 - 77, 1000, 3750
    xs = np.stack([_gated(L, 1500, 4500), _gated(L, 4000, 7000), _gated(L, -1, 6200)])
    kw = dict(alpha=0.05, squelch=True, threshold=20.0)
    jp, tp = jagc.make_params(**kw), tagc.make_params(**kw)
    js, ts = jagc.agc_init(squelch=True), tagc.agc_init(squelch=True)
    tbatch = tagc.AgcState(*(v.expand(3).clone() for v in ts))
    if route == "pallas":
        tres = agc_scan.agc_chunked_pallas_ref(tp, tbatch, torch.from_numpy(xs), chunk,
                                               warmup)
        jrun = lambda x: agc_chunked_pallas(jp, js, jnp.asarray(x), chunk=chunk,
                                            warmup=warmup, interpret=True)
    else:
        tres = tagc.agc_apply_chunked(tp, tbatch, torch.from_numpy(xs), chunk, warmup)
        jrun = lambda x: jagc.agc_apply_chunked(jp, js, jnp.asarray(x), chunk, warmup)
    tst, (ty, tm) = tres
    for c in range(3):
        _agc_compare(jrun(xs[c]), (tagc.AgcState(*(v[c] for v in tst)), (ty[c], tm[c])))
    assert {1, 2, 3, 4, 5} <= set(np.unique(tm.numpy()))
