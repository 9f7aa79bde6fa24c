"""The port's fused front end against tpudsp's, c64 / i16 / u8, over two
streamed blocks so the carried tail is exercised. Tolerance: 120 dB SNR
(both sides are f32 matmuls of the same taps; only the summation order
differs), and the carried raw tail must be equal exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.util import snr_db
from tpudsp.chains import am as jam
from tpudsp.kernels import decimate as jdec
from tpudsp_torch.chains import am as tam
from tpudsp_torch.kernels import decimate as tdec

BLOCK = 50_000   # n_out = 1200 per block at the default rate


def _wire(fmt, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (0.4 * np.exp(2j * np.pi * 0.0013 * t)
         + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    if fmt == "c64":
        return x.astype(np.complex64)
    if fmt == "i16":
        return np.stack([np.round(x.real * 32767), np.round(x.imag * 32767)],
                        -1).astype(np.int16)
    return np.stack([np.round(x.real * 127.5 + 127.5),
                     np.round(x.imag * 127.5 + 127.5)], -1).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_fused_frontend_matches_tpudsp(fmt):
    cfg = jam.AMConfig()
    P, Q = jam._rational(cfg.rate)
    jp, js, n_out = jam.build(cfg, BLOCK, fmt)
    tp, ts, _ = tam.build(tam.AMConfig(), BLOCK, fmt, device="cpu")
    nj = n_out // P
    jtail, ttail = js.rs_tail, ts.rs_tail
    for blk in range(2):
        x = _wire(fmt, BLOCK, seed=blk)
        if fmt == "c64":
            jtail, jy = jdec.fused_frontend_apply_shared(
                jp.taps_fused, jtail, jnp.asarray(x), Q, nj)
            ttail, ty = tdec.fused_frontend_apply_shared(
                tp.taps_fused, ttail, torch.from_numpy(x), Q, nj)
        elif fmt == "i16":
            jtail, jy = jdec.fused_frontend_apply_shared_i16(
                jp.taps_fused, jtail, jnp.asarray(x), Q, nj)
            ttail, ty = tdec.fused_frontend_apply_shared_i16(
                tp.taps_fused, ttail, torch.from_numpy(x), Q, nj)
        else:
            jtail, jy = jdec.fused_frontend_apply_shared_u8(
                jp.taps_fused, jp.u8_dc, jtail, jnp.asarray(x), Q, nj)
            ttail, ty = tdec.fused_frontend_apply_shared_u8(
                tp.taps_fused, tp.u8_dc, ttail, torch.from_numpy(x), Q, nj)
        assert ty.dtype == torch.complex64 and ty.shape == (n_out,)
        s = snr_db(np.asarray(jy), ty.numpy())
        assert s > 120.0, f"block {blk}: {s:.1f} dB"
        np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))


def test_plan_fused_frontend_equal():
    cfg = jam.AMConfig()
    jp, _, _ = jam.build(cfg, BLOCK)
    tp, _, _ = tam.build(tam.AMConfig(), BLOCK, device="cpu")
    np.testing.assert_array_equal(tp.taps_fused.numpy(), np.asarray(jp.taps_fused))
