"""The port's sharded receiver bank (``parallel.ShardedBank`` on CPU
tensors: the plain versions of every kernel) against the JAX package's
``ShardedBank`` on its 8-device CPU mesh, mesh shape for mesh shape, over
two streamed blocks with carried state; mirrors tests/test_sharding.py.
The JAX bank's parameters and state are carried over with
``convert.bank_from_jax`` and cut to each rank's channel slice
(``parallel/bank.channel_slice``, what ``convert.sharded_bank_from_jax``
does).

Meshes of four ranks ((2, 2), (1, 4), (4, 1)) run as spawned gloo
processes (tests/torch_ranks.py), every case of the file in one spawn (the
``ring4`` fixture); the (1, 1) mesh runs here. The coherent AM cases use
a faster AGC loop (bandwidth 0.05), which cuts the warmup window to 1280
channel samples and so the plain front scan's steps (the JAX test's
default loop needs 4x the block).

Bars (SNR over each channel's audio after the first SKIP samples): FM
and SSB channels >= 90 dB from tpudsp; coherent AM channels >= 60 dB from
tpudsp's sharded back end, which is its XLA one (libm atan2 where the
port's front scan takes the patan2 polynomial: tests/test_torch_bank.py's
bar), past the loops' settling quarter as the JAX test holds them. The
port against its own single-card ``ReceiverBank``: >= 120 dB on a (1, 1)
mesh, >= 90 dB on sharded meshes (FM), the wire formats against c64 of
their values at the JAX test's bars, and halo='async' equal to
halo='ppermute' bit for bit (on the CPU both run the same plain front).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_sharded_am import jax_f32_powers
from tests.torch_ranks import run_ranks
from tests.util import snr_db
from tpudsp_torch import convert
from tpudsp_torch.chains.bank import BankConfig, ReceiverBank
from tpudsp_torch.parallel import ShardedBank, make_mesh
from tpudsp_torch.parallel import bank as pbank

FS = 2_400_000.0
N = 120_000           # samples a block: 12,000 at the channel rate, 2400 audio
FREQS = (250_000.0, -400_000.0, 100_000.0, -150_000.0)
SKIP = 50
FM = BankConfig(freqs=FREQS, iq_rate=FS, demod="fm", kd=0.3125)
AM = BankConfig(freqs=FREQS, iq_rate=FS, demod="am", am_coherent=True, agc_bandwidth=0.05)
MIXED = BankConfig(freqs=FREQS, iq_rate=FS, demod=("am", "fm", "am", "usb"),
                   am_coherent=True, agc_bandwidth=0.05)
PORT_POWERS = pbank._powers
N0_WRAP = 2 ** 32 - N // 2 - 1000   # the index wraps 1000 samples into rank 2's slice


def fm_iq(n, seed=0):
    t = np.arange(n)
    out = 0
    for i, f in enumerate(FREQS):
        m = np.sin(2 * np.pi * (700.0 + 400.0 * i) / FS * t)
        out = out + np.exp(1j * (2 * np.pi * f / FS * t + 2 * np.pi * 0.03125 * np.cumsum(m)))
    rng = np.random.default_rng(seed)
    out = out + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (out / len(FREQS)).astype(np.complex64)


def am_iq(n):
    t = np.arange(n)
    out = 0
    for i, f in enumerate(FREQS):
        m = np.sin(2 * np.pi * (900.0 + 500.0 * i) / FS * t)
        out = out + (1 + 0.5 * m) * 0.3 * np.exp(2j * np.pi * (f + 20.0 + 5.0 * i) / FS * t)
    return (out / len(FREQS)).astype(np.complex64)


def wire(x, fmt):
    """(raw (n, 2) wire samples, the c64 of their values)."""
    if fmt == "i16":
        w = np.stack([np.round(x.real * 32767 * 0.5),
                      np.round(x.imag * 32767 * 0.5)], 1).astype(np.int16)
        return w, ((w[:, 0] + 1j * w[:, 1]) / 32767.0).astype(np.complex64)
    w = np.stack([np.round(x.real * 127.5 * 0.5 + 127.5),
                  np.round(x.imag * 127.5 * 0.5 + 127.5)], 1).clip(0, 255).astype(np.uint8)
    return w, ((w[:, 0] - 127.5) / 127.5 + 1j * (w[:, 1] - 127.5) / 127.5).astype(np.complex64)


def blocks_of(x):
    return [x[:N], x[N:]]


def jax_run(cfg, shape, blocks):
    """The JAX bank on a mesh of ``shape`` virtual CPU devices: (its
    parameters and initial state as the port's whole-bank tensors, its
    audio over the blocks)."""
    from tpudsp.chains.bank import BankConfig as JBankConfig
    from tpudsp.parallel import make_mesh as jmesh
    from tpudsp.parallel.bank import ShardedBank as JShardedBank
    jb = JShardedBank(JBankConfig(**dataclasses.asdict(cfg)), jmesh(*shape), block_len=N)
    carried = convert.bank_from_jax(jb.params, jb.state, device="cpu")
    return carried, np.concatenate([np.asarray(jb(b)) for b in blocks], 1)


def port_audio(cfg, shape, blocks, carried=None, jax_powers=False, n0=None, **kw):
    """This rank's ShardedBank over ``blocks`` (every rank returns the whole
    audio); ``carried``: a whole bank's (params, state) from ``convert``;
    ``n0``: the stream's global index at the first block."""
    mesh = make_mesh(*shape, "cpu")
    sb = ShardedBank(cfg, mesh, N, device="cpu", **kw)
    if carried is not None:
        sb.params, sb.state = pbank.channel_slice(*carried, mesh)
    if n0 is not None:
        sb.state = sb.state._replace(n0=torch.tensor(n0))
    if jax_powers:
        pbank._powers = jax_f32_powers
    try:
        return torch.cat([sb(torch.from_numpy(b)) for b in blocks], 1).numpy()
    finally:
        pbank._powers = PORT_POWERS


def _ring_rank(rank, world, tmp_path, cases):
    for name, args in cases.items():
        np.save(tmp_path / f"{name}_{rank}.npy", port_audio(*args[:4], **args[4]))


def ring_audio(tmp_path, world, cases):
    """{name: audio} of ``port_audio(*cases[name])`` on a spawned ring of
    ``world`` ranks; every rank's audio must be the same."""
    run_ranks(tmp_path, world, _ring_rank, tmp_path, cases, timeout=240.0)
    out = {}
    for name in cases:
        ys = [np.load(tmp_path / f"{name}_{r}.npy") for r in range(world)]
        for y in ys[1:]:
            np.testing.assert_array_equal(y, ys[0])
        out[name] = ys[0]
    return out


def channel_snr(ref, y, chans=None, skip=SKIP):
    assert y.shape == ref.shape and y.dtype == np.float32 and np.all(np.isfinite(y))
    chans = range(ref.shape[0]) if chans is None else chans
    return min(snr_db(ref[c, skip:], y[c, skip:]) for c in chans)


# name: (config, mesh shape, signal) of the cases held against JAX
JAX_CASES = {
    "fm_2x2": (FM, (2, 2), "fm"),
    "fm_1x4": (FM, (1, 4), "fm"),
    "am_2x2": (AM, (2, 2), "am"),
    "mixed_2x2": (MIXED, (2, 2), "am"),
}


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    """Every four-rank case in one spawn: the JAX audio of JAX_CASES and the
    port's from JAX's parameters, the async halo, the (4, 1) mesh and the
    wire formats against c64 of their values."""
    sig = {"fm": blocks_of(fm_iq(2 * N)), "am": blocks_of(am_iq(2 * N))}
    jax_out, cases = {}, {}
    for name, (cfg, shape, s) in JAX_CASES.items():
        carried, jax_out[name] = jax_run(cfg, shape, sig[s])
        cases[name] = (cfg, shape, sig[s], carried, dict(jax_powers=cfg.am_coherent))
    cases["fm_1x4_async"] = (FM, (1, 4), sig["fm"], None, dict(halo="async"))
    cases["fm_1x4_own"] = (FM, (1, 4), sig["fm"], None, {})
    cases["fm_4x1"] = (FM, (4, 1), sig["fm"], None, {})
    cases["fm_1x4_wrap"] = (FM, (1, 4), sig["fm"], None, dict(n0=N0_WRAP))
    for fmt in ("i16", "u8"):
        w, c = wire(fm_iq(2 * N, seed=3), fmt)
        cases[f"wire_{fmt}"] = (FM, (2, 2), blocks_of(w), None, dict(input_format=fmt))
        cases[f"wire_{fmt}_c64"] = (FM, (2, 2), blocks_of(c), None, {})
    return sig, jax_out, ring_audio(tmp_path_factory.mktemp("ring4"), 4, cases)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_bank_matches_jax(ring4, name):
    """Four-rank meshes against tpudsp's ShardedBank on the same mesh: the
    FM bank at (2, 2) and (1, 4), the coherent AM bank at (2, 2), the
    mixed am / fm / am / usb bank with the channel axis sharded ('all';
    'gather', the channels local, runs on the (1, 1) mesh below)."""
    _, jax_out, port = ring4
    cfg = JAX_CASES[name][0]
    y_jax, y = jax_out[name], port[name]
    demods = cfg.demod if isinstance(cfg.demod, tuple) else (cfg.demod,) * cfg.nchan
    am = [c for c, d in enumerate(demods) if d == "am"]
    rest = [c for c, d in enumerate(demods) if d != "am"]
    settle = y.shape[1] // 4      # the coherent loops' acquisition
    if rest:
        s = channel_snr(y_jax, y, rest)
        print(f"{name} fm/ssb: {s:.2f} dB")
        assert s >= 90.0
    if am:
        s = channel_snr(y_jax, y, am, skip=settle)
        print(f"{name} coherent am: {s:.2f} dB")
        assert s >= 60.0


@pytest.mark.parametrize("cfg,sig", [(FM, "fm"), (MIXED, "am")])
def test_one_rank_mesh_matches_jax_and_receiver_bank(cfg, sig):
    """The (1, 1) mesh, the FM bank and the mixed one (its coherent AM rows
    gathered, 'gather'), from tpudsp's design as it ships (float64-rounded
    entry powers, which cost nothing at these bars): against tpudsp's
    ShardedBank on a (1, 1) mesh, and against the port's single-card
    ReceiverBank (backend 'xla': the sharded back end's chunk) on the
    same blocks >= 120 dB (the same launches but for the de-emphasis and
    DC tracker, whose entry values are added after a zero-entry scan)."""
    blocks = blocks_of(fm_iq(2 * N) if sig == "fm" else am_iq(2 * N))
    carried, y_jax = jax_run(cfg, (1, 1), blocks)
    y = port_audio(cfg, (1, 1), blocks, carried)
    demods = cfg.demod if isinstance(cfg.demod, tuple) else (cfg.demod,) * cfg.nchan
    am = [c for c, d in enumerate(demods) if d == "am"]
    rest = [c for c, d in enumerate(demods) if d != "am"]
    if rest:
        assert channel_snr(y_jax, y, rest) >= 90.0
    if am:
        assert channel_snr(y_jax, y, am, skip=y.shape[1] // 4) >= 60.0
    ref = ReceiverBank(cfg, N, backend="xla", device="cpu")
    y_ref = np.concatenate([ref(torch.from_numpy(b)).numpy() for b in blocks], 1)
    s = channel_snr(y_ref, y, skip=0)
    print(f"(1, 1) vs ReceiverBank: {s:.2f} dB")
    assert s >= 120.0


def test_sharded_meshes_match_the_single_card_bank(ring4):
    """The port's own (1, 4) and (4, 1) FM banks against its single-card
    ReceiverBank over one block of twice the length (the carried state
    across shard and block boundaries); async equal to ppermute."""
    sig, _, port = ring4
    ref = ReceiverBank(FM, 2 * N, device="cpu")
    y_ref = ref(torch.from_numpy(np.concatenate(sig["fm"]))).numpy()
    for name in ("fm_1x4_own", "fm_4x1"):
        s = channel_snr(y_ref, port[name])
        print(f"{name} vs ReceiverBank: {s:.2f} dB")
        assert s >= 90.0
    np.testing.assert_array_equal(port["fm_1x4_async"], port["fm_1x4_own"])


def test_global_index_wraps_as_the_single_card_bank(ring4):
    """A stream whose 32-bit global sample index wraps inside rank 2's slice
    of the first block: each rank's rotation starts at its global index
    masked to 32 bits, as the single-card bank's lattice does, so the (1,
    4) bank stays on the single-card ReceiverBank carrying the same index
    (>= 90 dB; a rank offset left unmasked would rotate every later rank's
    channels off their carriers)."""
    sig, _, port = ring4
    ref = ReceiverBank(FM, N, device="cpu")
    ref.state = ref.state._replace(n0=torch.tensor(N0_WRAP))
    y_ref = np.concatenate([ref(torch.from_numpy(b)).numpy() for b in sig["fm"]], 1)
    assert channel_snr(y_ref, port["fm_1x4_wrap"]) >= 90.0


@pytest.mark.parametrize("fmt", ["i16", "u8"])
def test_sharded_bank_wire_format_matches_converted(ring4, fmt):
    """input_format 'i16' / 'u8' on a (2, 2) mesh, the (K1-1)-sample input
    halo crossing at wire width, against the c64 bank on the converted
    values: the JAX test's bars (u8 60 dB past 64 samples on block 0)."""
    _, _, port = ring4
    yw, yc = port[f"wire_{fmt}"], port[f"wire_{fmt}_c64"]
    m = N // 50
    if fmt == "i16":
        assert snr_db(yc, yw) > 85.0
    else:
        assert snr_db(yc[:, 64:m], yw[:, 64:m]) > 60.0
        assert snr_db(yc[:, m:], yw[:, m:]) > 85.0


class _Coordinate:
    """A stand-in for a (2, 2) mesh, seen from the rank at ``coord``."""
    mesh_dim_names = ("channel", "time")

    def __init__(self, coord):
        self.coord = coord

    def size(self, mesh_dim=None):
        return 2

    def get_local_rank(self, mesh_dim=None):
        return self.coord[self.mesh_dim_names.index(mesh_dim)]


def test_sharded_bank_from_jax_cuts_the_channel_slice():
    """convert.sharded_bank_from_jax: the JAX bank's global parameters and
    state, cut to the rank's channel slice (every per-channel leaf, the
    coherent front included), the shared leaves whole."""
    from tpudsp.chains.bank import BankConfig as JBankConfig
    from tpudsp.parallel import make_mesh as jmesh
    from tpudsp.parallel.bank import ShardedBank as JShardedBank
    jb = JShardedBank(JBankConfig(**dataclasses.asdict(MIXED)), jmesh(2, 2), block_len=N)
    whole_p, whole_s = convert.bank_from_jax(jb.params, jb.state, device="cpu")
    p, s = convert.sharded_bank_from_jax(jb.params, jb.state, _Coordinate((1, 0)), device="cpu")
    assert torch.equal(p.taps_re, whole_p.taps_re[2:]) and torch.equal(p.h2, whole_p.h2)
    assert torch.equal(p.dtheta, whole_p.dtheta[2:]) and p.dtheta.dtype == torch.int64
    assert torch.equal(s.a_tail, whole_s.a_tail[2:]) and torch.equal(s.in_tail, whole_s.in_tail)
    assert s.front.agc.g.shape == (2,) and torch.equal(s.dc, whole_s.dc[2:])
    mine = ShardedBank(MIXED, _Coordinate((1, 0)), N, device="cpu")
    for a, b in zip(p, mine.params):
        if torch.is_tensor(a):
            assert a.shape == b.shape and a.dtype == b.dtype


def test_sharded_bank_rules():
    mesh = make_mesh(1, 1, "cpu")
    cases = [(dict(halo="ring"), ValueError, "unknown halo"),
             (dict(input_format="f32"), ValueError, "unknown input_format"),
             (dict(block_len=N + 10), ValueError, "multiple of 50"),
             (dict(cfg=BankConfig(freqs=FREQS, demod="usb"), block_len=1000), ValueError,
              "taps2_ssb")]
    for kw, err, match in cases:
        args = dict(cfg=FM, mesh=mesh, block_len=N, device="cpu")
        args.update(kw)
        with pytest.raises(err, match=match):
            ShardedBank(**args)
    with pytest.raises(ValueError, match="channel count"):
        ShardedBank(BankConfig(freqs=FREQS[:3]), _Coordinate((0, 0)), N, device="cpu")
    sb = ShardedBank(FM, mesh, N, input_format="i16", device="cpu")
    with pytest.raises(TypeError, match="expects \\(N, 2\\)"):
        sb(np.zeros(N, np.complex64))
    with pytest.raises(ValueError, match="expected block"):
        sb(np.zeros((N - 50, 2), np.int16))
