"""The port's AGC scans (the plain versions of csrc/agc_scan.cu) against
tpudsp's, on the same inputs made with numpy:

- ``kernels/agc.agc_apply`` vs tpudsp's exact ``agc_apply`` (lax.scan);
- ``kernels/agc.agc_apply_chunked`` (the XLA route) vs tpudsp's
  ``agc_apply_chunked``;
- ``cuda/agc_scan.agc_chunked_pallas_ref`` (the Pallas route) vs
  ``pallas/agc_scan.agc_chunked_pallas`` in interpret mode.

Cases: a level step, squelch on, a ragged last chunk (every chunked case),
and a warmup longer than the chunk. Bars: y >= 100 dB, modes equal, final
g / y2p within rtol 1e-5, final squelch mode and timer equal. Measured on
the CPU: y 123.6-135.0 dB, modes equal, g / y2p within 2.4e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import snr_db, tones
from tpudsp.kernels import agc as jagc
from tpudsp.pallas.agc_scan import agc_chunked_pallas
from tpudsp_torch.cuda import agc_scan
from tpudsp_torch.kernels import agc as tagc
from tpudsp_torch.kernels import lanes


def _level_step(n):
    amp = np.where(np.arange(n) < n // 2, 0.05, 0.5)
    return (tones(n, [0.01]) * amp).astype(np.complex64)


def _gated(n):
    """Loud between samples 3000 and 6000, -80 dB elsewhere."""
    t = np.arange(n)
    amp = np.where((t > 3000) & (t < 6000), 1.0, 1e-4)
    return (np.exp(2j * np.pi * 0.02 * t) * amp).astype(np.complex64)


# name: (signal, n, AGC params, chunk, warmup)
CASES = {
    "level_step": (_level_step, 20_000, dict(alpha=0.01), 1024, 2048),
    "squelch": (_gated, 8000, dict(alpha=0.05, squelch=True, threshold=20.0),
                1024, 2048),
    # the AGC op's numbers at alpha = 0.01: warmup 3840 > chunk 1024 (Pallas
    # route) and chunk = warmup = 3840 (XLA route)
    "op_pallas": (_level_step, 12_000, dict(alpha=0.01), 1024, 3840),
    "op_xla": (_level_step, 12_000, dict(alpha=0.01), 3840, 3840),
}


def _setup(case):
    sig, n, kw, chunk, warmup = CASES[case]
    x = sig(n)
    squelch = kw.get("squelch", False)
    return (x, chunk, warmup,
            (jagc.make_params(**kw), jagc.agc_init(squelch=squelch)),
            (tagc.make_params(**kw), tagc.agc_init(squelch=squelch)))


def _compare(jres, tres):
    (jst, (jy, jm)), (tst, (ty, tm)) = jres, tres
    jy, ty = np.asarray(jy), ty.numpy()
    assert ty.shape == jy.shape and ty.dtype == np.complex64
    s = snr_db(jy, ty)
    assert s >= 100.0, f"{s:.1f} dB"
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for f in ("g", "y2p"):
        np.testing.assert_allclose(float(getattr(tst, f)), float(getattr(jst, f)),
                                   rtol=1e-5)
    assert int(tst.sq_mode) == int(jst.sq_mode)
    assert int(tst.sq_timer) == int(jst.sq_timer)


@pytest.mark.parametrize("case", ["level_step", "squelch"])
def test_agc_apply_matches_tpudsp(case):
    x, _, _, (jp, js), (tp, ts) = _setup(case)
    x = x[:6000]   # a Python loop per sample here: keep it short
    _compare(jagc.agc_apply(jp, js, jnp.asarray(x)),
             tagc.agc_apply(tp, ts, torch.from_numpy(x)))


@pytest.mark.parametrize("case", ["level_step", "squelch", "op_xla"])
def test_agc_apply_chunked_matches_tpudsp(case):
    x, chunk, warmup, (jp, js), (tp, ts) = _setup(case)
    assert len(x) % chunk and len(x) > chunk + warmup   # ragged, chunked
    _compare(jagc.agc_apply_chunked(jp, js, jnp.asarray(x), chunk, warmup),
             tagc.agc_apply_chunked(tp, ts, torch.from_numpy(x), chunk, warmup))


@pytest.mark.parametrize("case", ["level_step", "squelch", "op_pallas"])
def test_pallas_route_matches_agc_chunked_pallas(case):
    x, chunk, warmup, (jp, js), (tp, ts) = _setup(case)
    assert len(x) % chunk and len(x) > chunk + warmup
    jres = agc_chunked_pallas(jp, js, jnp.asarray(x), chunk=chunk,
                              warmup=warmup, interpret=True)
    _compare(jres, agc_scan.agc_chunked_pallas_ref(
        tp, ts, torch.from_numpy(x), chunk, warmup))


@pytest.mark.parametrize("route", ["agc_chunked_pallas", "agc_chunked"])
def test_wrappers_take_the_plain_version_on_cpu(route):
    """On a CPU batch the dispatching wrappers return their plain versions'
    results and launch no kernel."""
    x, chunk, warmup, _, (tp, ts) = _setup("squelch")
    tail = "prev" if route == "agc_chunked_pallas" else "entry"
    ref = tagc.agc_apply_chunked(tp, ts, torch.from_numpy(x), chunk, warmup,
                                 tail=tail)
    st, (y, m) = getattr(agc_scan, route)(
        tp, lanes.one_stream(ts), torch.from_numpy(x)[None], chunk, warmup)
    assert torch.equal(y[0], ref[1][0]) and torch.equal(m[0], ref[1][1])
    assert all(torch.equal(a[0], b) for a, b in zip(st, ref[0]))
    assert agc_scan._launch.launches == 0
