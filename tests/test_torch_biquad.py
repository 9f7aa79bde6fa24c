"""The port's compensated SOS cascade (``kernels/iir.sos_apply_df``, the
plain version of csrc/biquad_scan.cu) and the complex64 entry of the
blocked one-pole (``kernels/iir.first_order_apply_blocked_c64``, the plain
version of csrc/first_order_scan.cu's complex64 entry), on the CPU:

- ``sos_split_df`` equal to tpudsp's bit for bit;
- the cascade against the float64 sample-serial SosFilterOracle on the
  JAX package's hard config (cheby2 order 8, Fc 0.0075): >= 120 dB, its
  bar (measured 148.8 dB on 20,000 samples); against tpudsp's
  sos_apply_df; block invariance >= 100 dB (measured 144.8 dB); the
  block, tile and fold-window edges of csrc/biquad_scan.cu's geometry
  (SOS_L, SOS_TILE, SOS_WINDOW) and BroadcastAM's near-unit-pole DC block
  against float64;
- the host table: its head is ``sos_split_df``'s values, its powers
  numpy.linalg.matrix_power's, split;
- the complex one-pole against its JAX twin, whose block carry is plain
  complex64 (the gap pinned), and against float64;
- the wrappers on CPU tensors: the plain versions' bits, no launch; on a
  tensor that is on no CUDA device they raise rather than fall back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle.liquid_oracle import SosFilterOracle
from tests.util import noise, snr_db
from tpudsp.design import iirdes
from tpudsp.kernels import iir as jiir
from tpudsp_torch.cuda import biquad_scan, first_order
from tpudsp_torch.kernels import iir as tiir

HARD = iirdes.iirdes_sos("cheby2", "lowpass", 8, 0.0075, As=60.0, Ap=0.5)
DC_BLOCK = iirdes.iirdes_sos("cheby2", "highpass", 3, 20.0 / 48000.0, Ap=0.5, As=20.0)


def _table(sos):
    return torch.from_numpy(tiir.sos_table(sos))


def _x(n, cplx=True, seed=1):
    return noise(n, complex_out=cplx, seed=seed).astype(np.complex64 if cplx else np.float32)


def _run(sos, x, pieces=None, state=None):
    """The port's cascade over x in consecutive pieces (sizes; the rest
    last). Returns (state, y)."""
    tab = _table(sos)
    st = tiir.sos_init(sos, torch.complex64 if np.iscomplexobj(x) else torch.float32) \
        if state is None else state
    edges = np.cumsum([0, *(pieces or [])])
    ys = []
    for a, b in zip(edges, [*edges[1:], len(x)]):
        st, y = tiir.sos_apply_df(tab, st, torch.from_numpy(x[a:b]))
        ys.append(y.numpy())
    return st, np.concatenate(ys)


@pytest.mark.parametrize("which", ["hard", "dc_block"])
def test_split_equals_tpudsp(which):
    sos = HARD if which == "hard" else DC_BLOCK
    for a, b in zip(jiir.sos_split_df(sos), tiir.sos_split_df(sos)):
        np.testing.assert_array_equal(np.asarray(a), b)
    tab = tiir.sos_table(sos)
    A_hi, A_lo, c_hi, c_lo, b0 = tiir.sos_split_df(sos)
    np.testing.assert_array_equal(tab[:, 0], A_hi[:, 0, 0])
    np.testing.assert_array_equal(tab[:, 3], A_lo[:, 1, 0])
    np.testing.assert_array_equal(tab[:, 8], b0)
    np.testing.assert_array_equal(tab[:, 9:tiir.SOS_HEAD], 0)
    # the powers: A^(L m), A^k, A^(T m) in the table's order, each split
    L, T = tiir.SOS_L, tiir.SOS_TILE
    ks = [*(L * m for m in range(tiir.SOS_TB)), *range(1, L + 1),
          *(T * m for m in range(tiir.SOS_WINDOW))]
    assert len(ks) == tiir.SOS_NPOW
    assert tiir.SOS_SAMPLE_POW + 1 == tiir.SOS_TB and ks[tiir.SOS_TILE_POW + 1] == T
    pw = tab[:, tiir.SOS_HEAD:].reshape(len(sos), 4, 2, tiir.SOS_NPOW)
    for s, (_, _, _, _, a1, a2) in enumerate(np.asarray(sos, np.float64)):
        A = np.array([[-a1, 1.0], [-a2, 0.0]])
        P = np.stack([np.linalg.matrix_power(A, k) for k in ks]).reshape(-1, 4).T
        hi = P.astype(np.float32)
        np.testing.assert_array_equal(pw[s, :, 0], hi)
        np.testing.assert_array_equal(pw[s, :, 1], (P - hi).astype(np.float32))
    # A^0 is the identity, split exactly
    np.testing.assert_array_equal(pw[..., 0].reshape(len(sos), 8),
                                  np.tile([1, 0, 0, 0, 0, 0, 1, 0], (len(sos), 1)))


def test_hard_config_vs_oracle():
    """>= 120 dB against float64 on the config where a plain f32 scan
    floors near 60 dB."""
    x = _x(4096)
    _, y = _run(HARD, x)
    assert snr_db(SosFilterOracle(HARD)(x), y) > 120.0


def test_hard_config_vs_tpudsp():
    """>= 130 dB against tpudsp's double-float associative scan on the
    same block (real input; both are within ~1e-7 of float64, so they
    agree at the f32 output rounding)."""
    x = _x(4096, cplx=False, seed=4)
    st = np.asarray(noise(8, complex_out=False, seed=5).reshape(4, 2), np.float32) * 0.1
    _, yj = jiir.sos_apply_df(jiir.sos_split_df(HARD), jnp.asarray(st), jnp.asarray(x))
    tst, yt = _run(HARD, x, state=torch.from_numpy(st))
    assert snr_db(np.asarray(yj), yt) > 130.0
    assert tst.shape == (4, 2) and tst.dtype == torch.float32


def test_block_invariance():
    """The same stream in pieces of 7, 993, 1 and the rest: >= 100 dB
    against one call (the carried state is f32 at block edges)."""
    x = _x(3000, seed=2)
    _, y_full = _run(HARD, x)
    _, y_cat = _run(HARD, x, pieces=[7, 993, 1])
    assert snr_db(y_full, y_cat) > 100.0


_L, _T = tiir.SOS_L, tiir.SOS_TILE


@pytest.mark.parametrize("n", [1, _L - 1, _L, _L + 1, 32, 33, _T - 1, _T, _T + 1, 2 * _T + 5,
                               8191, 8193, 16389])
def test_block_and_tile_edges_vs_oracle(n):
    """Lengths at the kernel's block of SOS_L and tile of SOS_TILE samples
    (and at 32 / 8192, first_order_scan's), real, carried state over two
    calls: >= 120 dB against float64."""
    x = _x(2 * n, cplx=False, seed=n)
    _, y = _run(HARD, x, pieces=[n])
    assert snr_db(SosFilterOracle(HARD)(x), y) > 120.0


@pytest.mark.parametrize("which", ["hard", "dc_block"])
def test_rows_across_fold_windows_vs_oracle(which):
    """A first call longer than one fold window of SOS_WINDOW tiles (its
    tiles' entries folded in two windows, handed from one to the next),
    then a second from the carried state: >= 120 dB against float64."""
    sos = HARD if which == "hard" else DC_BLOCK
    n = tiir.SOS_WINDOW * tiir.SOS_TILE + 2 * tiir.SOS_TILE + 5
    x = _x(n + 3000, cplx=False, seed=9)
    if which == "dc_block":
        x = (x * 0.1 + 1.0).astype(np.float32)
    _, y = _run(sos, x, pieces=[n])
    assert snr_db(SosFilterOracle(sos)(x), y) > 120.0


def test_near_unit_pole_dc_block_vs_oracle():
    """BroadcastAM's DC block (poles at radius ~0.9983) on an offset
    signal: >= 120 dB against float64."""
    x = (_x(20_000, cplx=False, seed=3) * 0.1 + 1.0).astype(np.float32)
    _, y = _run(DC_BLOCK, x, pieces=[5000])
    assert snr_db(SosFilterOracle(DC_BLOCK)(x), y) > 120.0


def test_c64_one_pole_vs_tpudsp_and_float64():
    """The pilot smoother's one-pole (rho = 0.999) over two chained calls:
    >= 115 dB against the JAX twin, whose block carry is plain complex64
    (measured 128.3 / 125.5 dB; the JAX twin is 127.8 / 125.3 dB from
    float64), and >= 130 dB against float64 (measured 142.8 / 138.0 dB),
    where the double-float carry leaves only the within-block f32
    rounding: the port is the more precise, by design."""
    rho, n = 0.999, 10_000
    x = _x(2 * n, seed=6)
    jp, tp = jnp.complex64(0.3 - 0.2j), torch.tensor(0.3 - 0.2j, dtype=torch.complex64)
    ref = np.empty(2 * n, np.complex128)
    e = 0.3 - 0.2j
    for m in range(2 * n):
        e = rho * e + (1 - rho) * np.complex128(x[m])
        ref[m] = e
    for k in range(2):
        xs = x[k * n:(k + 1) * n]
        jp, jy = jiir.first_order_apply_blocked_c64(1 - rho, rho, jp, jnp.asarray(xs))
        tp, ty = tiir.first_order_apply_blocked_c64(1 - rho, rho, tp, torch.from_numpy(xs))
        assert ty.dtype == torch.complex64 and ty.shape == (n,)
        r = ref[k * n:(k + 1) * n]
        assert snr_db(np.asarray(jy), ty.numpy()) > 115.0
        assert snr_db(r, ty.numpy()) > 130.0
        assert snr_db(r, ty.numpy()) > snr_db(r, np.asarray(jy)) + 5.0
        assert complex(tp) == complex(ty[-1])


def test_wrappers_take_the_plain_versions_on_cpu():
    """cuda/biquad_scan and cuda/first_order's complex64 entry on CPU
    tensors return the plain versions' bits and launch nothing."""
    tab = _table(HARD)
    st = tiir.sos_init(HARD, torch.complex64)
    x = torch.from_numpy(_x(3000, seed=7))
    before = (biquad_scan.sos_apply_df.launches, first_order.first_order_apply_blocked_c64.launches)
    ks, ky = biquad_scan.sos_apply_df(tab, st, x)
    rs, ry = tiir.sos_apply_df(tab, st, x)
    assert torch.equal(ky, ry) and torch.equal(ks, rs)
    kl, ky = first_order.first_order_apply_blocked_c64(0.001, 0.999, 0.5j, x)
    rl, ry = tiir.first_order_apply_blocked_c64(0.001, 0.999, 0.5j, x)
    assert torch.equal(ky, ry) and torch.equal(kl, rl)
    assert (biquad_scan.sos_apply_df.launches,
            first_order.first_order_apply_blocked_c64.launches) == before


def test_kernel_launch_refuses_non_cuda_tensors():
    """A tensor on neither the CPU nor a CUDA device (meta) goes to the
    launch path, which refuses it: there is no fallback to the plain
    version, and nothing is counted."""
    meta = torch.device("meta")
    before = (biquad_scan.sos_apply_df.launches, first_order.first_order_apply_blocked_c64.launches)
    with pytest.raises(ValueError, match="CUDA"):
        biquad_scan.sos_apply_df(_table(HARD).to(meta), torch.zeros((4, 2), device=meta),
                                 torch.zeros(64, device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        first_order.first_order_apply_blocked_c64(
            0.5, 0.5, 0j, torch.zeros(64, dtype=torch.complex64, device=meta))
    assert (biquad_scan.sos_apply_df.launches,
            first_order.first_order_apply_blocked_c64.launches) == before
