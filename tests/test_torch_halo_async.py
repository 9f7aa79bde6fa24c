"""The async-halo front end's plain version (``cuda/halo_async.
bank_front_async`` on CPU tensors: the halo exchange on a gloo ring, then
``cfir_ref``) against the JAX package's ``bank_front_async(...,
interpret=True)`` under shard_map on the same numpy inputs, and against
the port's ``strided_cfir_matmul_wide*`` over the concatenated carried
tail and input. Shapes as tests/test_halo_async.py.

Rings of 2 and 4 ranks run as spawned gloo processes (tests/torch_ranks.py)
that import no jax; the JAX side runs in this process on its virtual CPU
devices. A ring of one needs no process group and runs here.
"""

import numpy as np
import pytest
import torch

from tests.torch_ranks import run_ranks
from tests.util import snr_db
from tpudsp_torch.cuda import halo_async as kasync
from tpudsp_torch.kernels import decimate as tdec
from tpudsp_torch.parallel import make_mesh

C, K1, D1 = 16, 128, 10
# the wire scale rides the taps, as chains/bank.build folds it
SCALE = {"c64": 1.0, "i16": 1.0 / 32767.0, "u8": 1.0 / 127.5}


def _taps(C, K1, D1, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    taps = (rng.standard_normal((C, K1))
            + 1j * rng.standard_normal((C, K1))) * scale
    return (tdec.plan_phase_taps(taps.real.astype(np.float32), D1),
            tdec.plan_phase_taps(taps.imag.astype(np.float32), D1))


def _samples(n, fmt, seed):
    """n samples and a K1-1 sample carried tail, c64 or raw (n, 2) wire."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n + K1 - 1) + 1j * rng.standard_normal(n + K1 - 1)) * 0.1
    if fmt == "i16":
        w = np.stack([np.round(x.real * 32767), np.round(x.imag * 32767)], 1)
        w = np.clip(w, -32767, 32767).astype(np.int16)
    elif fmt == "u8":
        w = np.stack([x.real, x.imag], 1) * 127.5 + 127.5
        w = np.clip(np.round(w), 0, 255).astype(np.uint8)
    else:
        w = x.astype(np.complex64)
    return w[K1 - 1:], w[:K1 - 1]


def _jax_front(x, tail, Tre, Tim, T, nj_loc, tile, d1=D1):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from tpudsp.pallas.halo_async import bank_front_async
    from tpudsp.parallel.mesh import TIME_AXIS
    mesh = Mesh(np.asarray(jax.devices()[:T]), (TIME_AXIS,))
    f = jax.jit(jax.shard_map(
        lambda iq, tl: bank_front_async(iq, tl, jnp.asarray(Tre), jnp.asarray(Tim),
                                        d1, nj_loc, TIME_AXIS, T, tile=tile,
                                        interpret=True),
        mesh=mesh, in_specs=(P(TIME_AXIS), P()), out_specs=P(None, TIME_AXIS),
        check_vma=False))
    return np.asarray(f(jnp.asarray(x), jnp.asarray(tail)))


def _wide(fmt):
    return {"c64": tdec.strided_cfir_matmul_wide,
            "i16": tdec.strided_cfir_matmul_wide_i16,
            "u8": tdec.strided_cfir_matmul_wide_u8}[fmt]


def _port_rank(rank, world, tmp_path, x, tail, Tre, Tim, nj_loc):
    """One rank of the port's ring: its slice through bank_front_async."""
    n_loc = x.shape[0] // world
    mesh = make_mesh(1, world, device="cpu")
    y = kasync.bank_front_async(torch.from_numpy(x[rank * n_loc:(rank + 1) * n_loc]),
                                torch.from_numpy(tail), torch.from_numpy(Tre),
                                torch.from_numpy(Tim), D1, nj_loc, mesh)
    np.save(tmp_path / f"y{rank}.npy", y.numpy())


def _port_front(tmp_path, x, tail, Tre, Tim, T, nj_loc, d1=D1):
    if T == 1:
        return kasync.bank_front_async(
            torch.from_numpy(x), torch.from_numpy(tail), torch.from_numpy(Tre),
            None if Tim is None else torch.from_numpy(Tim), d1, nj_loc,
            make_mesh(1, 1, "cpu")).numpy()
    run_ranks(tmp_path, T, _port_rank, tmp_path, x, tail, Tre, Tim, nj_loc)
    return np.concatenate([np.load(tmp_path / f"y{r}.npy") for r in range(T)], 1)


@pytest.mark.parametrize("T,fmt,tile", [(1, "c64", 2048), (2, "c64", 128),
                                        (4, "c64", 1024), (2, "i16", 128),
                                        (2, "u8", 128)])
def test_port_matches_jax_bank_front_async(tmp_path, T, fmt, tile):
    """>= 120 dB against JAX's kernel (its own bar against the ppermute
    path); T=1 is the ring of one, whose boundary tile must use the
    carried tail. ``tile`` is the Pallas tile of the JAX call; the port
    has none."""
    c = 8 if T == 1 else C
    n = 20_000 if T == 1 else 40_000 * T // 4
    n -= n % (T * D1)
    Tre, Tim = _taps(c, K1, D1, SCALE[fmt], seed=T)
    x, tail = _samples(n, fmt, seed=10 + T)
    nj_loc = n // T // D1
    y_jax = _jax_front(x, tail, Tre, Tim, T, nj_loc, tile)
    y = _port_front(tmp_path, x, tail, Tre, Tim, T, nj_loc)
    assert y.shape == y_jax.shape == (c, n // D1) and y.dtype == np.complex64
    assert snr_db(y_jax, y) > 120.0

    # the same outputs from the port's wide matmul over [tail | x]
    X = torch.from_numpy(np.concatenate([tail, x]))
    y_wide = _wide(fmt)(X, torch.from_numpy(Tre), torch.from_numpy(Tim), D1,
                        n // D1).numpy()
    # u8: the wide form subtracts the offset's DC term after the dot, the
    # kernel centres before it; both round the same sums differently
    assert snr_db(y_wide, y) > (100.0 if fmt == "u8" else 120.0)


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_strided_cfir_matmul_wide_matches_jax(fmt):
    """The port's three wide forms against tpudsp's on the same inputs."""
    from tpudsp.kernels import decimate as jdec
    Tre, Tim = _taps(C, K1, D1, SCALE[fmt], seed=5)
    x, tail = _samples(4_000, fmt, seed=6)
    X = np.concatenate([tail, x])
    nj = 4_000 // D1
    jf = {"c64": jdec.strided_cfir_matmul_wide,
          "i16": jdec.strided_cfir_matmul_wide_i16,
          "u8": jdec.strided_cfir_matmul_wide_u8}[fmt]
    y_jax = np.asarray(jf(X, Tre, Tim, D1, nj))
    y = _wide(fmt)(torch.from_numpy(X), torch.from_numpy(Tre),
                   torch.from_numpy(Tim), D1, nj).numpy()
    assert y.shape == y_jax.shape == (C, nj)
    # u8 subtracts the offset's DC term from sums ~127x the signal, so the
    # two summation orders part at ~110 dB there (measured 109.6)
    assert snr_db(y_jax, y) > (100.0 if fmt == "u8" else 120.0)


def test_real_taps_match_jax_with_zero_imaginary_taps(tmp_path):
    """Tim None, the AM path's real taps (the kernel's real-tap instance
    on the card), against JAX's kernel given zero imaginary taps: the
    AM shape's 3 phases of Kc = 24 frames of D1 = 125 on a ring of one."""
    rng = np.random.default_rng(3)
    Kc, Q = 24, 125
    Tre = (rng.standard_normal((3, Kc, Q)) / np.sqrt(Kc * Q)).astype(np.float32)
    n = 40 * Q
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3).astype(np.complex64)
    tail = ((rng.standard_normal(Kc * Q - 227) + 1j * rng.standard_normal(Kc * Q - 227))
            * 0.3).astype(np.complex64)
    y_jax = _jax_front(x, tail, Tre, np.zeros_like(Tre), 1, n // Q, 1024, d1=Q)
    y = _port_front(tmp_path, x, tail, Tre, None, 1, n // Q, d1=Q)
    assert y.shape == y_jax.shape == (3, n // Q)
    assert snr_db(y_jax, y) > 120.0


def test_boundary_split_and_checks():
    assert kasync.boundary(127, 10, 4000) == 13       # least S covering the halo
    assert kasync.boundary(2773, 125, 32000) == 23
    assert kasync.boundary(127, 10, 5) == 5           # fewer outputs than S
    assert kasync.pack_taps(torch.ones(3, 2, 5), None).dtype == torch.float32
    Tre, Tim = (torch.from_numpy(t) for t in _taps(2, K1, D1))
    x = torch.zeros(1000, dtype=torch.float32)
    with pytest.raises(ValueError, match="complex64 or"):
        kasync.bank_front_async(x, x[:K1 - 1], Tre, Tim, D1, 100,
                                make_mesh(1, 1, "cpu"))
    xc = torch.zeros(1000, dtype=torch.complex64)
    with pytest.raises(ValueError, match="runs on CUDA"):
        kasync._launch(xc, xc[:K1 - 1], kasync.pack_taps(Tre, Tim),
                       torch.empty((2, 100), dtype=torch.complex64), D1, 0, 100)
    assert kasync._launch.launches == 0


def test_pack_taps_is_made_once_per_taps_tensor():
    """pack_taps' cached result equals a fresh pack, is the same tensor on
    the next call with the same taps, and is made anew for other taps or
    after the taps change in place."""
    Tre, Tim = (torch.from_numpy(t) for t in _taps(3, K1, D1, seed=4))
    for im in (Tim, None):
        got = kasync.pack_taps(Tre, im)
        assert torch.equal(got, kasync._pack(Tre, im))
        assert kasync.pack_taps(Tre, im) is got
    other = Tre.clone()
    assert kasync.pack_taps(other, Tim) is not kasync.pack_taps(Tre, Tim)
    before = kasync.pack_taps(other, Tim)
    other.mul_(2.0)
    after = kasync.pack_taps(other, Tim)
    assert torch.equal(after, kasync._pack(other, Tim)) and not torch.equal(after, before)


@pytest.mark.parametrize("real", [True, False], ids=["real_taps", "complex_taps"])
def test_kernel_launch_refuses_cpu_tensors(real):
    """The launch path never falls back to the plain version: CPU tensors,
    with the cached taps of either kind, are refused and nothing is
    counted."""
    Tre, Tim = (torch.from_numpy(t) for t in _taps(2, K1, D1, seed=6))
    xc = torch.zeros(1000, dtype=torch.complex64)
    before = kasync._launch.launches
    with pytest.raises(ValueError, match="runs on CUDA"):
        kasync._launch(xc, xc[:K1 - 1], kasync.pack_taps(Tre, None if real else Tim),
                       torch.empty((2, 100), dtype=torch.complex64), D1, 0, 100)
    assert kasync._launch.launches == before
