"""The blocked first-order recurrence of the port (the plain versions of
csrc/first_order_scan.cu in kernels/iir, and their wrapper
cuda/first_order on CPU tensors) against tpudsp's blocked scan:

- C rows in one call against one tpudsp call per row;
- the tiled log-depth double-float carry alone against the float64
  recurrence and against the sequential carry in the JAX package's order;
- the AM receiver's linear tail against the composition of tpudsp's XLA
  back end (two blocked scans with the audio line between them);
- lengths at and around one block of L = 32 and one tile of 256 blocks;
- the wrapper on CPU tensors: the plain version's bits, no launch; its
  launch refuses tensors that are not on a CUDA device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util import snr_db
from tpudsp.design import iirdes
from tpudsp.kernels import iir as jiir
from tpudsp_torch.cuda import first_order
from tpudsp_torch.kernels import agc as tagc
from tpudsp_torch.kernels import am_backend as tab
from tpudsp_torch.kernels import iir as tiir

DC_RHO = 0.9995
COEFFS = {
    "dc_tracker": (1.0 - DC_RHO, DC_RHO),
    "deemphasis": iirdes.deemphasis_coeffs(48000.0),
}


def _signal(shape, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1])
    return (0.3 * np.sin(2 * np.pi * 1000 / 48000 * t) + 0.2
            + 0.01 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("which", sorted(COEFFS))
def test_rows_match_tpudsp_per_row(which):
    """C = 3 rows with distinct carries in one call, over two chained
    calls: each row >= 120 dB against its own 1-D tpudsp call (the same
    within-block sums; T rounded from float64 against tpudsp's f32
    powers)."""
    b0, a = COEFFS[which]
    n = 5_000
    x = _signal((3, 2 * n), seed=1)
    x[1] *= -2.0
    carries = np.array([0.0, 0.5, -1.0], np.float32)
    ty_prev = torch.from_numpy(carries)
    jy_prev = [jnp.float32(v) for v in carries]
    for k in range(2):
        xs = x[:, k * n:(k + 1) * n]
        ty_prev, ty = tiir.first_order_apply_blocked(b0, a, ty_prev, torch.from_numpy(xs))
        assert ty.shape == (3, n) and ty_prev.shape == (3,)
        for c in range(3):
            jy_prev[c], jy = jiir.first_order_apply_blocked(b0, a, jy_prev[c],
                                                            jnp.asarray(xs[c]))
            s = snr_db(np.asarray(jy), ty[c].numpy())
            assert s > 120.0, f"{which} call {k} row {c}: {s:.1f} dB"
            assert float(ty_prev[c]) == float(ty[c, -1])


def _powers(a):
    """The block powers a^(L m), m = 0..TILE_BLOCKS, of the host table as
    (hi, lo) tensors."""
    pairs = torch.from_numpy(tiir.block_table(0.0, a)[32 * 33:].reshape(-1, 2))
    return pairs[:, 0], pairs[:, 1]


def _carry_sequential(aL, y_prev, S):
    """The JAX package's order of the block carry (its lax.scan body),
    one block after the other: E[0] = (y_prev, 0), E[b+1] = a^L E[b] +
    (S[b], 0)."""
    ch, cl = y_prev, torch.zeros_like(y_prev)
    EH, EL = torch.empty_like(S), torch.empty_like(S)
    for b in range(S.shape[1]):
        EH[:, b], EL[:, b] = ch, cl
        ch, cl = tiir._df_add(tiir._df_mul(aL, (ch, cl)), (S[:, b], torch.zeros_like(ch)))
    return EH, EL


def _carry_case(which):
    _, a = COEFFS[which]
    rng = np.random.default_rng(3)
    S = rng.standard_normal((2, 3000)).astype(np.float32)
    y0 = rng.standard_normal(2).astype(np.float32)
    return a, S, y0


@pytest.mark.parametrize("which", sorted(COEFFS))
def test_carry_matches_float64(which):
    """The tiled log-depth carry alone, E[b+1] = a^L E[b] + S[b] over 3000
    blocks (the AM shape's, 12 tiles of 256) from distinct entries: (hi,
    lo) within 2^-44 relative of the float64 recurrence."""
    a, S, y0 = _carry_case(which)
    EH, EL = tiir._carry(_powers(a), torch.from_numpy(y0), torch.from_numpy(S))
    c = np.float64(a) ** 32
    ref = np.empty(S.shape)
    e = y0.astype(np.float64)
    for b in range(S.shape[1]):
        ref[:, b] = e
        e = c * e + S[:, b]
    got = EH.double().numpy() + EL.double().numpy()
    assert np.max(np.abs(got - ref)) <= 2.0 ** -44 * np.max(np.abs(ref))


@pytest.mark.parametrize("which", sorted(COEFFS))
def test_carry_matches_sequential_order(which):
    """The tiled log-depth carry against the sequential carry in the JAX
    package's order, over 3000 blocks from distinct entries: the two
    orders part by at most 2^-44 relative."""
    a, S, y0 = _carry_case(which)
    EH, EL = tiir._carry(_powers(a), torch.from_numpy(y0), torch.from_numpy(S))
    aL = tuple(torch.tensor(v, dtype=torch.float32) for v in tiir._split64(np.float64(a) ** 32))
    SH, SL = _carry_sequential(aL, torch.from_numpy(y0), torch.from_numpy(S))
    got = EH.double().numpy() + EL.double().numpy()
    seq = SH.double().numpy() + SL.double().numpy()
    assert np.max(np.abs(got - seq)) <= 2.0 ** -44 * np.max(np.abs(seq))


def _tail_params(carrier):
    de_b0, de_a = iirdes.deemphasis_coeffs(48000.0)
    return tab.make_params(tagc.make_params(alpha=0.01, scale=0.01), 0.5, de_b0,
                           de_a, carrier=carrier)


@pytest.mark.parametrize("carrier", [True, False], ids=["use_dc", "no_dc"])
def test_linear_tail_matches_xla_composition(carrier):
    """kernels/iir.linear_tail against tpudsp's blocked DC tracker, the
    audio line and its blocked de-emphasis, over two chained blocks of a
    ragged length: >= 120 dB, carries within f32 rounding."""
    p = _tail_params(carrier)
    n = 6_291
    vr = _signal((2 * n,), seed=2)
    use_dc, inv_mod = np.float32(float(p.use_dc)), np.float32(float(p.inv_mod))
    jdc, jde = jnp.float32(0.1), jnp.float32(-0.2)
    tdc, tde = torch.tensor(0.1), torch.tensor(-0.2)
    for k in range(2):
        v = vr[k * n:(k + 1) * n]
        jdc, track = jiir.first_order_apply_blocked(1.0 - p.dc_rho, p.dc_rho, jdc,
                                                    jnp.asarray(v))
        audio = (jnp.asarray(v) - track * use_dc) * inv_mod
        jde, jpcm = jiir.first_order_apply_blocked(p.deemph_b0, p.deemph_a, jde, audio)
        (tdc, tde), tpcm = tiir.linear_tail(p, tdc, tde, torch.from_numpy(v))
        assert tpcm.shape == (n,) and tdc.shape == () and tde.shape == ()
        s = snr_db(np.asarray(jpcm), tpcm.numpy())
        assert s > 120.0, f"block {k}: {s:.1f} dB"
        # within a few f32 roundings of the input's scale (|vr| ~ 0.5,
        # inv_mod 2), as the outputs differ
        np.testing.assert_allclose(float(tdc), float(jdc), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(tde), float(jde), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 7, 32, 33])
def test_block_edge_lengths_match_tpudsp(n):
    """A block shorter than L, exactly L and one past it, over two chained
    calls: >= 130 dB against the float64 serial recurrence (measured >= 147
    dB) and >= 110 dB against tpudsp, whose f32 powers of the f32 pole
    alone put it 127 dB from float64 at these lengths; y_last the last
    output."""
    b0, a = COEFFS["dc_tracker"]
    x = _signal((2 * n,), seed=4) + 1.0
    jy_prev, ty_prev = jnp.float32(0.7), torch.tensor(0.7)
    e = 0.7
    for k in range(2):
        xs = x[k * n:(k + 1) * n]
        ref = np.empty(n)
        for m, v in enumerate(xs.astype(np.float64)):
            e = a * e + b0 * v
            ref[m] = e
        jy_prev, jy = jiir.first_order_apply_blocked(b0, a, jy_prev, jnp.asarray(xs))
        ty_prev, ty = tiir.first_order_apply_blocked(b0, a, ty_prev, torch.from_numpy(xs))
        assert ty.shape == (n,)
        assert snr_db(ref, ty.numpy()) > 130.0
        assert snr_db(np.asarray(jy), ty.numpy()) > 110.0
        assert float(ty_prev) == float(ty[-1])


def test_block_table_values():
    """The host table: T = b0 a^(i-j) on and below the diagonal, zeros
    above, a^(i+1), and each block power's (hi, lo) split summing to
    float64 a^(L m), m = 0..256, within 2^-46 relative (and half of f32's
    least subnormal, where the de-emphasis's powers leave its range)."""
    b0, a = COEFFS["deemphasis"]
    tab_ = tiir.block_table(b0, a)
    assert tab_.dtype == np.float32 and tab_.shape == (tiir.TABLE_SIZE,)
    assert tiir.TABLE_SIZE == 32 * 32 + 32 + 2 * 257
    T = tab_[:1024].reshape(32, 32).astype(np.float64)
    i = np.arange(32)
    np.testing.assert_allclose(np.diag(T), b0, rtol=1e-7)
    np.testing.assert_allclose(T[5, 2], b0 * a ** 3, rtol=1e-7)
    assert np.all(T[np.triu_indices(32, 1)] == 0.0)
    np.testing.assert_allclose(tab_[1024:1056], a ** (i + 1.0), rtol=1e-7)
    for pole in (a, DC_RHO):
        hi, lo = tiir.block_table(b0, pole)[1056:].astype(np.float64).reshape(-1, 2).T
        want = np.float64(pole) ** (32.0 * np.arange(257))
        assert hi[0] == 1.0 and lo[0] == 0.0
        assert np.all(np.abs(hi + lo - want) <= 2.0 ** -46 * want + 2.0 ** -150)


TILE = 256 * 32   # samples of one tile of the carry scan


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 2 * TILE + 5])
def test_tile_edge_lengths_match_tpudsp(n):
    """Lengths at the carry scan's tile edges, 3 rows with distinct
    carries over two chained calls: each row >= 120 dB against its own
    tpudsp call and >= 130 dB against the float64 serial recurrence;
    y_last the last output."""
    b0, a = COEFFS["dc_tracker"]
    x = _signal((3, 2 * n), seed=7)
    x[1] *= -2.0
    carries = np.array([0.0, 0.5, -1.0], np.float32)
    ty_prev = torch.from_numpy(carries)
    jy_prev = [jnp.float32(v) for v in carries]
    e = carries.astype(np.float64)
    for k in range(2):
        xs = x[:, k * n:(k + 1) * n]
        ty_prev, ty = tiir.first_order_apply_blocked(b0, a, ty_prev, torch.from_numpy(xs))
        ref = np.empty(xs.shape)
        for m in range(n):
            e = a * e + b0 * xs[:, m].astype(np.float64)
            ref[:, m] = e
        for c in range(3):
            jy_prev[c], jy = jiir.first_order_apply_blocked(b0, a, jy_prev[c],
                                                            jnp.asarray(xs[c]))
            assert snr_db(np.asarray(jy), ty[c].numpy()) > 120.0
            assert snr_db(ref[c], ty[c].numpy()) > 130.0
            assert float(ty_prev[c]) == float(ty[c, -1])


def test_wrappers_take_the_plain_versions_on_cpu():
    """cuda/first_order on CPU tensors returns the plain versions' bits and
    launches nothing."""
    b0, a = COEFFS["dc_tracker"]
    x = torch.from_numpy(_signal((2, 3_000), seed=5))
    before = first_order._launch.launches
    last, y = first_order.first_order_apply_blocked(b0, a, torch.tensor([0.1, 0.2]), x)
    rlast, ry = tiir.first_order_apply_blocked(b0, a, torch.tensor([0.1, 0.2]), x)
    assert torch.equal(y, ry) and torch.equal(last, rlast)
    p = _tail_params(True)
    (dc, de), pcm = first_order.linear_tail(p, torch.tensor(0.0), torch.tensor(0.0), x[0])
    (rdc, rde), rpcm = tiir.linear_tail(p, torch.tensor(0.0), torch.tensor(0.0), x[0])
    assert torch.equal(pcm, rpcm) and torch.equal(dc, rdc) and torch.equal(de, rde)
    assert first_order._launch.launches == before


def test_kernel_launch_refuses_non_cuda_tensors():
    """The launch path never falls back to the plain version: tensors that
    are not on a CUDA device are refused, and nothing is counted."""
    tab_ = tiir.device_table(0.5, 0.5, torch.device("cpu"))
    before = first_order._launch.launches
    with pytest.raises(ValueError, match="CUDA"):
        first_order._launch("first_order_scan", (tab_,), None, torch.zeros((1, 64)),
                            (torch.zeros(1),))
    assert first_order._launch.launches == before
