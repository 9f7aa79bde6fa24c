"""The port's time-sharded AM receiver (``parallel.ShardedAMReceiver`` on
CPU tensors, plain versions of every kernel) against the JAX package's
on the same samples, with the same ring size and halo mode, over two
streamed blocks; the JAX receiver's taps and state are carried over with
``convert.sharded_am_from_jax``.

Rings of 2 and 4 ranks run as spawned gloo processes
(tests/torch_ranks.py) that import no jax; a ring of one runs here. The
ring of two runs every case in one spawn (the ``ring2`` fixture), since
starting the ranks costs more than the cases. Each rank's audio slice
must cover the loops' warmup. The tests run the default chain with a
faster AGC loop (bandwidth 0.05 instead of 0.01), which cuts the warmup
from 3840 to 1280 pcm samples and so each rank's least slice from
160,000 to 53,375 samples: the plain front scan costs ~0.6 ms a sample on
the CPU. The default configuration runs at full width on the card
(chip_smoke.py).

Bars: >= 100 dB for c64 and >= 90 dB for wire input, the chain bar and
the wire bar of PERF.md section 2. The port's front scan uses the patan2
polynomial where the JAX sharded back end uses libm atan2 (the same
difference as tests/test_torch_chain.py's pin against the XLA back end).

One difference is the port's by design. The cross-rank DC tracker and
de-emphasis add a^(k+1) times a rank's entry value; the JAX receiver
raises the f32-rounded pole to f32 powers, which for the DC tracker
(a = 0.9995) is off by ~2.3e-8 k relative, and the port rounds float64
powers. Past the first rank's first block that costs the JAX receiver
its 100 dB (``test_port_against_oracle_chain``). So the comparisons with
JAX swap JAX's powers into the port (``jax_f32_powers``), and the oracle
test holds the port as it ships. The ring of four is in
tests/test_torch_sharded_am_ring4.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_ranks import run_ranks
from tests.util import snr_db
from tpudsp_torch import convert
from tpudsp_torch.chains.am import AMConfig, AMReceiver
from tpudsp_torch.cuda import halo_async
from tpudsp_torch.parallel import ShardedAMReceiver, make_mesh
from tpudsp_torch.parallel import bank as pbank

CFG = AMConfig(agc_bandwidth=0.05)
N_LOC = 53_375                    # samples per rank and block
PCM_LOC = N_LOC * 48 // 2_000     # 1281 pcm samples per rank and block
PORT_POWERS = pbank._powers
BAR = {"c64": 100.0, "i16": 90.0, "u8": 90.0}
RING2 = [("ppermute", "c64"), ("async", "c64"), ("ppermute", "i16"),
         ("ppermute", "u8")]


def make_blocks(T, fmt, seed=0):
    """Two blocks of one AM stream (1 kHz tone, 200 Hz carrier offset,
    light noise), as c64 or raw (n, 2) wire samples."""
    n = 2 * N_LOC * T
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    x = ((1 + 0.5 * np.sin(2 * np.pi * 1000 / 2e6 * t)) * 0.3
         * np.exp(2j * np.pi * 200 / 2e6 * t)
         + 0.003 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    if fmt == "i16":
        x = np.stack([np.round(x.real * 32767), np.round(x.imag * 32767)],
                     1).astype(np.int16)
    elif fmt == "u8":
        x = np.round(np.stack([x.real, x.imag], 1) * 127.5
                     + 127.5).astype(np.uint8)
    else:
        x = x.astype(np.complex64)
    return [x[:n // 2], x[n // 2:]]


def jax_run(T, halo, fmt, blocks):
    """The JAX receiver on a time-only mesh of T virtual CPU devices:
    (its taps and initial state as port tensors, its pcm)."""
    import jax
    from jax.sharding import Mesh
    from tpudsp.chains.am import AMConfig as JAMConfig
    from tpudsp.parallel import ShardedAMReceiver as JSAM
    from tpudsp.parallel.mesh import TIME_AXIS
    mesh = Mesh(np.asarray(jax.devices()[:T]), (TIME_AXIS,))
    # the interpret-mode async kernel needs the replication check off, as
    # tests/test_halo_async.py runs it
    jrx = JSAM(JAMConfig(**dataclasses.asdict(CFG)), mesh,
               block_len=N_LOC * T, halo=halo, input_format=fmt,
               check_vma=halo == "ppermute")
    carried = convert.sharded_am_from_jax(jrx._taps, jrx.state, device="cpu")
    return carried, np.concatenate([np.asarray(jrx(b)) for b in blocks])


def jax_f32_powers(a: float, n: int, device):
    """a^(k+1), k < n, as the JAX receiver forms them
    (tpudsp/parallel/bank.py:98-99): the f32-rounded pole raised to f32
    powers."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return torch.tensor(np.float32(a), device=device) ** (k + 1.0)


def port_pcm(T, halo, fmt, carried, blocks, jax_powers):
    """This rank's receiver over ``blocks`` (every rank returns the whole
    pcm); ``carried`` (taps, state) from ``convert``, or None for the
    port's own design; ``jax_powers`` swaps in ``jax_f32_powers``."""
    rx = ShardedAMReceiver(CFG, make_mesh(1, T, "cpu"), N_LOC * T, halo=halo,
                           input_format=fmt, device="cpu")
    if carried is not None:
        rx.taps, rx.state = carried
    if jax_powers:
        pbank._powers = jax_f32_powers
    try:
        return np.concatenate([rx(b).numpy() for b in blocks])
    finally:
        pbank._powers = PORT_POWERS


def _ring_rank(rank, world, tmp_path, runs):
    for name, args in runs.items():
        np.save(tmp_path / f"{name}_{rank}.npy", port_pcm(world, *args))


def ring_pcm(tmp_path, T, runs):
    """{name: pcm} of ``port_pcm(T, *args)`` for each ``runs[name]``, on a
    spawned ring of T ranks; every rank's pcm must be the same."""
    run_ranks(tmp_path, T, _ring_rank, tmp_path, runs)
    out = {}
    for name in runs:
        ys = [np.load(tmp_path / f"{name}_{r}.npy") for r in range(T)]
        for y in ys[1:]:
            np.testing.assert_array_equal(y, ys[0])
        out[name] = ys[0]
    return out


def check_pcm(y, y_ref, T, fmt, settle=0):
    assert y.shape == y_ref.shape == (2 * PCM_LOC * T,) and y.dtype == np.float32
    assert np.all(np.isfinite(y))
    s = snr_db(y_ref[settle:], y[settle:])
    print(f"T={T} {fmt}: {s:.2f} dB")      # shown with pytest -s
    assert s > BAR[fmt], f"{s:.2f} dB"
    return s


def oracle(blocks):
    from tests.test_chain_snr import oracle_am_chain
    return oracle_am_chain(np.concatenate(blocks).astype(np.complex128), CFG)


@pytest.fixture(scope="module")
def ring2(tmp_path_factory):
    """Every ring-of-two case in one spawn: the JAX pcm of each (halo,
    format) of RING2, the port's with JAX's powers, and the port's as it
    ships on c64 blocks."""
    runs, jax_pcm = {}, {}
    for halo, fmt in RING2:
        blocks = make_blocks(2, fmt)
        carried, jax_pcm[halo, fmt] = jax_run(2, halo, fmt, blocks)
        runs[f"{halo}_{fmt}"] = (halo, fmt, carried, blocks, True)
    runs["shipped"] = ("ppermute", "c64", None, make_blocks(2, "c64"), False)
    return jax_pcm, ring_pcm(tmp_path_factory.mktemp("ring2"), 2, runs)


@pytest.mark.parametrize("T,halo,fmt", [(1, "ppermute", "c64"),
                                        (1, "async", "c64")]
                         + [(2, h, f) for h, f in RING2])
def test_port_matches_jax_sharded_am(request, T, halo, fmt):
    """Both halo modes on rings of one and two, wire input on the ring of
    two (the figures on the CPU are in PERF.md)."""
    if T == 1:
        blocks = make_blocks(1, fmt)
        carried, y_jax = jax_run(1, halo, fmt, blocks)
        y = port_pcm(1, halo, fmt, carried, blocks, jax_powers=True)
    else:
        jax_pcm, port = request.getfixturevalue("ring2")
        y_jax, y = jax_pcm[halo, fmt], port[f"{halo}_{fmt}"]
    check_pcm(y, y_jax, T, fmt)


@pytest.mark.parametrize("T", [1, 2])
def test_port_against_oracle_chain(request, T):
    """The port as it ships (float64-rounded entry powers) against the
    float64 sample-serial oracle chain over both blocks, past the first
    block's settling half: >= 100 dB, and above the JAX receiver, whose
    f32 entry powers cost it there (on the CPU: port 129.2 / 126.0 dB,
    JAX 102.8 / 92.3 dB at T = 1 / 2)."""
    blocks = make_blocks(T, "c64")
    if T == 1:
        y = port_pcm(1, "ppermute", "c64", None, blocks, jax_powers=False)
        _, y_jax = jax_run(1, "ppermute", "c64", blocks)
    else:
        jax_pcm, port = request.getfixturevalue("ring2")
        y, y_jax = port["shipped"], jax_pcm["ppermute", "c64"]
    y_ref, settle = oracle(blocks), PCM_LOC * T // 2
    s = check_pcm(y, y_ref, T, "c64", settle=settle)
    s_jax = snr_db(y_ref[settle:], y_jax[settle:])
    print(f"T={T} JAX receiver: {s_jax:.2f} dB")
    assert s > s_jax


@pytest.mark.parametrize("halo", ["ppermute", "async"])
def test_ring_of_one_matches_am_receiver(halo):
    """The 1x1 mesh against the port's own AMReceiver on the same blocks:
    the same chain, with the DC tracker's and de-emphasis's entry values
    applied after a zero-entry scan instead of inside it."""
    blocks = make_blocks(1, "c64", seed=1)
    ref = AMReceiver(CFG, N_LOC, device="cpu")
    y_ref = np.concatenate([ref(torch.from_numpy(b)).numpy() for b in blocks])
    check_pcm(port_pcm(1, halo, "c64", None, blocks, False), y_ref, 1, "c64")
    assert halo_async._launch.launches == 0       # plain versions on the CPU


def test_value_errors():
    mesh = make_mesh(1, 1, "cpu")
    cases = [
        (dict(mesh=None), "needs a mesh"),
        (dict(halo="ring"), "unknown halo"),
        (dict(input_format="f32"), "unknown input_format"),
        (dict(halo="async", input_format="i16"), "wire-format ingest"),
        (dict(block_len=N_LOC + 1), "multiple of T\\*Q"),
        (dict(block_len=1000), "shorter than the loop warmup"),
        (dict(cfg=AMConfig(pcm_rate=48_000 * np.sqrt(2) / 1.4)), "rational rate"),
    ]
    for kw, match in cases:
        args = dict(cfg=CFG, mesh=mesh, block_len=N_LOC, device="cpu")
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            ShardedAMReceiver(**args)
    rx = ShardedAMReceiver(CFG, mesh, N_LOC, input_format="i16", device="cpu")
    with pytest.raises(TypeError, match="expects \\(N, 2\\)"):
        rx(np.zeros(N_LOC, np.complex64))
    with pytest.raises(ValueError, match="expected block"):
        rx(np.zeros((N_LOC - 125, 2), np.int16))
