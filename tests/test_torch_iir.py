"""The port's blocked first-order scan (the plain version of
csrc/first_order_scan.cu: sequential double-float carry, as tpudsp's)
against tpudsp's blocked scan and against the float64 serial oracle."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.oracle.liquid_oracle import FirstOrderOracle
from tests.util import snr_db
from tpudsp.design import iirdes
from tpudsp.kernels import iir as jiir
from tpudsp_torch.kernels import iir as tiir

DC_RHO = 0.9995


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (0.3 * np.sin(2 * np.pi * 1000 / 48000 * t) + 0.2
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


COEFFS = {
    "dc_tracker": (1.0 - DC_RHO, DC_RHO),
    "deemphasis": iirdes.deemphasis_coeffs(48000.0),
}


@pytest.mark.parametrize("which", sorted(COEFFS))
@pytest.mark.parametrize("n", [50_000, 12_345])
def test_blocked_scan_matches_tpudsp(which, n):
    """>= 120 dB: same within-block f32 matmul, carries that differ only
    below the f32 output rounding; two calls chain the carried state."""
    b0, a = COEFFS[which]
    x = _signal(2 * n)
    jy_prev, ty_prev = jnp.float32(0.1), torch.tensor(0.1)
    for k in range(2):
        xs = x[k * n:(k + 1) * n]
        jy_prev, jy = jiir.first_order_apply_blocked(b0, a, jy_prev, jnp.asarray(xs))
        ty_prev, ty = tiir.first_order_apply_blocked(b0, a, ty_prev, torch.from_numpy(xs))
        assert ty.dtype == torch.float32 and ty.shape == (n,)
        s = snr_db(np.asarray(jy), ty.numpy())
        assert s > 120.0, f"{which} call {k}: {s:.1f} dB"


def test_blocked_scan_vs_oracle_dc_tracker():
    """>= 100 dB against the f64 serial recurrence at rho = 0.9995 (the
    plain f32 associative scan floors at ~86.5 dB here)."""
    b0, a = COEFFS["dc_tracker"]
    x = _signal(50_000, seed=1)
    ref = FirstOrderOracle(b0, a)(x.astype(np.float64))
    last, y = tiir.first_order_apply_blocked(b0, a, torch.tensor(0.0), torch.from_numpy(x))
    s = snr_db(ref, y.numpy())
    assert s > 100.0, f"{s:.1f} dB"
    assert float(last) == float(y[-1])

