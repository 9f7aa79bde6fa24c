"""The port's channelizer with its transform split across ranks
(``parallel.ShardedChannelizer`` / ``ShardedChannelizedBank`` on CPU
tensors: the plain versions of every kernel, the two transposes as gloo
``all_to_all_single``s) against the JAX package's on its 8-device CPU
mesh, over streamed blocks with carried state; mirrors
tests/test_tp_channelizer.py. The JAX runtimes' taps, twiddles and state
are carried over with ``convert.tp_channelizer_from_jax`` /
``tp_bank_from_jax``, cut to each rank's slice.

Rings of four ranks run as spawned gloo processes (tests/torch_ranks.py),
every case of the file in one spawn (the ``ring4`` fixture); one-rank
meshes run here, with c1 > 1 so that the twiddle and both transform
stages run. The coherent AM bank uses a faster AGC loop (bandwidth 0.05)
to keep the plain front scan short.

Bars: Y >= 120 dB from tpudsp (tests/test_torch_channelizer.py's bar);
the FM audio of the carrier's channel >= 90 dB from tpudsp (the bank's
FM bar); the coherent AM carriers' audio >= 60 dB from tpudsp past the
settling quarter (tpudsp's sharded back end is its XLA one, libm atan2
where the port's front takes patan2); the port against its own
single-card Channelizer / ChannelizedBank: Y >= 120 dB, FM audio >=
100 dB; wire formats against the c64 of their values at the JAX test's
bars.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_ranks import run_ranks
from tests.util import snr_db
from tpudsp_torch import convert
from tpudsp_torch.chains.channelizer import (ChannelizedBank, ChannelizedBankConfig,
                                             Channelizer, ChannelizerConfig)
from tpudsp_torch.parallel import (ShardedChannelizedBank, ShardedChannelizer, ShardedScanner,
                                   channel_layout, make_mesh)
from tpudsp_torch.parallel.channelizer import TPBankState

FS = 6_400_000.0
C = 64


def iq_noise(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64) * 0.3


def fm_iq(n, chans=(10,), seed=0):
    t = np.arange(n)
    x = sum(0.5 * np.exp(1j * (2 * np.pi * (c / C) * t + 2 * np.pi * (25_000.0 / FS)
                               * np.cumsum(np.sin(2 * np.pi * (1500.0 + 300 * i) / FS * t))))
            for i, c in enumerate(chans))
    rng = np.random.default_rng(seed)
    return (x + 0.01 * rng.standard_normal(n)).astype(np.complex64)


def am_iq(n, stations):
    t = np.arange(n)
    x = sum((1 + 0.5 * np.sin(2 * np.pi * f / FS * t)) * 0.4
            * np.exp(2j * np.pi * (c / C + 4e-6) * t) for c, f in stations.items())
    return (x / len(stations)).astype(np.complex64)


def wire(x, fmt, scale=0.5):
    if fmt == "i16":
        w = np.stack([np.round(x.real * 32767 * scale),
                      np.round(x.imag * 32767 * scale)], 1).astype(np.int16)
        return w, ((w[:, 0] + 1j * w[:, 1]) / 32767.0).astype(np.complex64)
    w = np.stack([np.round(x.real * 127.5 * scale + 127.5),
                  np.round(x.imag * 127.5 * scale + 127.5)], 1).clip(0, 255).astype(np.uint8)
    return w, ((w[:, 0] - 127.5) / 127.5 + 1j * (w[:, 1] - 127.5) / 127.5).astype(np.complex64)


def split(x, n):
    return [x[i:i + n] for i in range(0, len(x), n)]


CH = {"tp8": ChannelizerConfig(nchan=C, taps_per_branch=8, iq_rate=FS),
      "tp6": ChannelizerConfig(nchan=C, taps_per_branch=6, iq_rate=FS),
      "tp128": ChannelizerConfig(nchan=128, taps_per_branch=8, iq_rate=FS),
      "os2": ChannelizerConfig(nchan=C, taps_per_branch=8, iq_rate=FS, oversample=2,
                               cutoff_frac=0.95)}
FMB = ChannelizedBankConfig(channelizer=CH["tp8"], demod="fm", kd=25_000.0 / (FS / C))
AMB = ChannelizedBankConfig(channelizer=CH["tp6"], demod="am", am_coherent=True,
                            agc_bandwidth=0.05)
MIXED = ChannelizedBankConfig(
    channelizer=ChannelizerConfig(nchan=16, taps_per_branch=8),
    demod=tuple("am" if i % 3 == 0 else "fm" for i in range(16)), am_coherent=True,
    agc_bandwidth=0.05)
STATIONS = {10: 1000.0, 33: 2500.0}


def _jcfg(cfg):
    """The JAX twin of a port config."""
    from tpudsp.chains import channelizer as jch
    if isinstance(cfg, ChannelizerConfig):
        return jch.ChannelizerConfig(**dataclasses.asdict(cfg))
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["channelizer"] = _jcfg(cfg.channelizer)
    return jch.ChannelizedBankConfig(**kw)


def jax_channelizer(cfg, n_dev, block, c1, blocks, fmt="c64", shape=None):
    """tpudsp's ShardedChannelizer on n_dev virtual devices: (its Ht, tw
    and tail as numpy, its natural-order Y over the blocks)."""
    from tpudsp.parallel import make_mesh as jmesh
    from tpudsp.parallel.channelizer import ShardedChannelizer as J
    sc = J(_jcfg(cfg), jmesh(*(shape or (1, n_dev))), block_len=block,
           axis_name=None if shape else "time", c1=c1, input_format=fmt)
    carried = tuple(np.asarray(v) for v in (sc.Ht, sc.tw, sc.tail))
    return carried, np.concatenate([sc(b) for b in blocks], 0)


def jax_bank(cfg, n_dev, block, blocks, shape=None, c1=None):
    """tpudsp's ShardedChannelizedBank: (its params and state in the port's
    types with host leaves, which a spawned rank can take without jax; its
    natural-order audio over the blocks)."""
    from tpudsp.parallel import make_mesh as jmesh
    from tpudsp.parallel.channelizer import ShardedChannelizedBank as J
    sb = J(_jcfg(cfg), jmesh(*(shape or (1, n_dev))), block_len=block,
           axis_name=None if shape else "time", c1=c1)
    Ht, tw, b0, a, amb, fm_mask = sb.params
    st = sb.state
    params = tuple(None if v is None else np.asarray(v) for v in (Ht, tw, b0, a)) + (
        convert._amb_from_jax(amb, "cpu"), None if fm_mask is None else np.asarray(fm_mask))
    state = TPBankState(*(np.asarray(v) for v in (st.tail, st.fd_prev, st.deemph)),
                        front=convert.op_state_from_jax(st.front, "cpu"),
                        dc=None if st.dc is None else np.asarray(st.dc))
    return (params, state), np.concatenate([np.asarray(sb(b)) for b in blocks], 1)


def port_run(kind, cfg, shape, block, blocks, carried=None, **kw):
    """The port's runtime on this rank over the blocks (every rank returns
    the whole result): kind 'ch' (ShardedChannelizer, Y concatenated over
    frames) or 'bank' (ShardedChannelizedBank, audio over time)."""
    mesh = make_mesh(*shape, "cpu")
    axis = "time" if shape[0] == 1 else "channel"
    if kind == "ch":
        rt = ShardedChannelizer(cfg, mesh, block, axis_name=axis, device="cpu", **kw)
        if carried is not None:
            rt.Ht, rt.tw, rt.tail = convert.tp_channelizer_from_jax(*carried, mesh, axis, "cpu")
        return torch.cat([rt(torch.from_numpy(b)) for b in blocks], 0).numpy()
    rt = ShardedChannelizedBank(cfg, mesh, block, axis_name=axis, device="cpu", **kw)
    if carried is not None:
        rt.params, rt.state = convert.tp_bank_from_jax(*carried, mesh, axis, "cpu")
    return torch.cat([rt(torch.from_numpy(b)) for b in blocks], 1).numpy()


def _ring_rank(rank, world, tmp_path, cases):
    for name, args in cases.items():
        np.save(tmp_path / f"{name}_{rank}.npy", port_run(*args[:6], **args[6]))


def ring_out(tmp_path, world, cases):
    run_ranks(tmp_path, world, _ring_rank, tmp_path, cases, timeout=240.0)
    out = {}
    for name in cases:
        ys = [np.load(tmp_path / f"{name}_{r}.npy") for r in range(world)]
        for y in ys[1:]:
            np.testing.assert_array_equal(y, ys[0])
        out[name] = ys[0]
    return out


# name: (config, c1, block) of the channelizer cases held against tpudsp
CH_CASES = {"c64": ("tp8", None, C * 128 * 4), "c128_c1_16": ("tp128", 16, 128 * 128 * 4),
            "os2": ("os2", None, C * 64 * 8)}
N_AM = C * 4096


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    """Every four-rank case in one spawn: each against tpudsp on the same
    mesh, from its carried design, and the port's wire formats, streaming
    and mixed bank."""
    jax_out, cases, data = {}, {}, {}
    for name, (key, c1, block) in CH_CASES.items():
        blocks = split(iq_noise(2 * block, seed=len(name)), block)
        carried, jax_out[name] = jax_channelizer(CH[key], 4, block, c1, blocks)
        cases[name] = ("ch", CH[key], (1, 4), block, blocks, carried, dict(c1=c1))
    nb = C * 128 * 8
    blocks = split(fm_iq(2 * nb), nb)
    carried, jax_out["bank_fm"] = jax_bank(FMB, 4, nb, blocks)
    cases["bank_fm"] = ("bank", FMB, (1, 4), nb, blocks, carried, {})
    blocks = split(am_iq(2 * N_AM, STATIONS), N_AM)
    carried, jax_out["bank_am"] = jax_bank(AMB, 4, N_AM, blocks)
    cases["bank_am"] = ("bank", AMB, (1, 4), N_AM, blocks, carried, {})
    nm = 16 * 8 * 64
    rng = np.random.default_rng(17)
    blocks = split(((rng.standard_normal(2 * nm) + 1j * rng.standard_normal(2 * nm)) * 0.1)
                   .astype(np.complex64), nm)
    carried, jax_out["bank_mixed"] = jax_bank(MIXED, 4, nm, blocks, shape=(4, 1))
    cases["bank_mixed"] = ("bank", MIXED, (4, 1), nm, blocks, carried, {})
    # the port alone: streaming, and the wire formats against c64 of their values
    ns = C * 64 * 8
    data["stream"] = iq_noise(3 * ns, seed=5)
    cases["stream"] = ("ch", CH["tp6"], (1, 4), ns, split(data["stream"], ns), None, {})
    for fmt in ("i16", "u8"):
        w, c = wire(iq_noise(2 * ns, seed=9), fmt, 0.5 if fmt == "i16" else 1.0)
        cases[f"ch_{fmt}"] = ("ch", CH["tp6"], (1, 4), ns, split(w, ns), None,
                              dict(input_format=fmt))
        cases[f"ch_{fmt}_c64"] = ("ch", CH["tp6"], (1, 4), ns, split(c, ns), None, {})
        x = sum(np.exp(1j * (2 * np.pi * (c_ / C) * np.arange(2 * ns) + 2 * np.pi * 0.05 / C
                             * np.cumsum(np.sin(2 * np.pi * 0.0005 * (i + 1)
                                                * np.arange(2 * ns)))))
                for i, c_ in enumerate((7, 40))) / 2
        w, c = wire(x, fmt, 0.5 if fmt == "i16" else 0.9)
        data[f"bank_{fmt}_c64"] = c
        cfg = ChannelizedBankConfig(channelizer=CH["tp6"], demod="fm", kd=0.25)
        cases[f"bank_{fmt}"] = ("bank", cfg, (1, 4), ns, split(w, ns), None,
                                dict(input_format=fmt))
    return data, jax_out, ring_out(tmp_path_factory.mktemp("ring4"), 4, cases)


@pytest.mark.parametrize("name", list(CH_CASES))
def test_tp_channelizer_matches_jax(ring4, name):
    """Four ranks against tpudsp's four devices: C = 64 (C1 = C2 = 8), C =
    128 with c1 = 16, and os = 2 (the odd frames' branch roll), two blocks
    each."""
    _, jax_out, port = ring4
    s = snr_db(jax_out[name], port[name])
    print(f"{name}: Y {s:.2f} dB")
    assert port[name].shape == jax_out[name].shape and s >= 120.0


@pytest.mark.parametrize("cfg_key,c1", [("tp8", None), ("tp8", 8), ("os2", 4)])
def test_one_rank_mesh_matches_jax_and_channelizer(cfg_key, c1):
    """A one-rank mesh (c1 > 1: the twiddle and both stages run; c1 None:
    C1 = 1) against tpudsp's one-device ShardedChannelizer and the port's
    single-card Channelizer, two blocks."""
    cfg, block = CH[cfg_key], C * 128
    blocks = split(iq_noise(2 * block, seed=2), block)
    carried, y_jax = jax_channelizer(cfg, 1, block, c1, blocks)
    y = port_run("ch", cfg, (1, 1), block, blocks, carried, c1=c1)
    ref = Channelizer(cfg, block, device="cpu")
    y_ref = np.concatenate([ref(torch.from_numpy(b)).numpy() for b in blocks], 0)
    assert snr_db(y_jax, y) >= 120.0 and snr_db(y_ref, y) >= 120.0
    if c1 is None:
        np.testing.assert_array_equal(y, y_ref)   # the single-card launch and IFFT


def test_tp_channelizer_streaming_matches_one_block(ring4):
    """Three blocks on four ranks against the single-card Channelizer over
    one block of three times the length (the carried tail across rank and
    block boundaries)."""
    data, _, port = ring4
    x = data["stream"]
    y_ref = Channelizer(CH["tp6"], len(x), device="cpu")(torch.from_numpy(x)).numpy()
    assert snr_db(y_ref, port["stream"]) >= 120.0


def test_tp_channelized_bank_matches_jax(ring4):
    """The FM bank on four ranks against tpudsp's: the carrier's channel
    >= 90 dB over both blocks (quiet channels demodulate float-level
    residuals, which differ between FFT orders)."""
    _, jax_out, port = ring4
    s = snr_db(jax_out["bank_fm"][10], port["bank_fm"][10])
    print(f"bank fm ch 10: {s:.2f} dB")
    assert s >= 90.0


def test_tp_channelized_bank_coherent_am_matches_jax(ring4):
    """Coherent AM behind the four-rank channelizer: each rank runs the
    feedback scans of its channels over the whole block."""
    _, jax_out, port = ring4
    a_j, a = jax_out["bank_am"], port["bank_am"]
    settle = a.shape[1] // 4
    for c in STATIONS:
        s = snr_db(a_j[c, settle:], a[c, settle:])
        print(f"bank am ch {c}: {s:.2f} dB")
        assert s >= 60.0


def test_tp_channelized_bank_mixed_demod_matches_jax(ring4):
    """A mixed fm / coherent am bank over a four-rank channel axis (16
    channels, C1 = C2 = 4): the coherent back end on every local row, the
    layout-ordered mask selecting, against tpudsp's on the same mesh."""
    _, jax_out, port = ring4
    s = snr_db(jax_out["bank_mixed"], port["bank_mixed"])
    print(f"bank mixed: {s:.2f} dB")
    assert s >= 60.0


@pytest.mark.parametrize("demod", ["fm", "am"])
def test_one_rank_bank_matches_jax_and_channelized_bank(demod):
    """The one-rank bank with c1 = 8 against tpudsp's one-device bank and
    the port's single-card ChannelizedBank (its default 'xla' chunk) on
    the same blocks: FM audio of the carrier >= 100 dB from the port's own
    bank, coherent AM carriers >= 100 dB from it and >= 60 dB from tpudsp
    past the settling quarter."""
    if demod == "fm":
        cfg, block = FMB, C * 256
        blocks, chans = split(fm_iq(2 * block), block), (10,)
    else:
        cfg, block = AMB, C * 2048
        blocks, chans = split(am_iq(2 * block, STATIONS), block), tuple(STATIONS)
    carried, a_j = jax_bank(cfg, 1, block, blocks, c1=8)
    a = port_run("bank", cfg, (1, 1), block, blocks, carried, c1=8)
    ref = ChannelizedBank(cfg, block, device="cpu")
    a_ref = np.concatenate([ref(torch.from_numpy(b)).numpy() for b in blocks], 1)
    settle = a.shape[1] // 4 if demod == "am" else 0
    for c in chans:
        s_j, s_r = (snr_db(r[c, settle:], a[c, settle:]) for r in (a_j, a_ref))
        print(f"one-rank bank {demod} ch {c}: tpudsp {s_j:.2f} dB, ChannelizedBank {s_r:.2f} dB")
        assert s_j >= (90.0 if demod == "fm" else 60.0) and s_r >= 100.0


@pytest.mark.parametrize("fmt", ["i16", "u8"])
def test_tp_channelizer_wire_format_matches_converted(ring4, fmt):
    """Raw wire slices framed at wire width on each rank (the boundary
    halo at wire width, u8's offset per branch before the transform)
    against the c64 transform of their values, two blocks; block 0's
    first 8 frames of u8 left out (the tail starts at 127, not 127.5)."""
    _, _, port = ring4
    Y_w, Y_c = port[f"ch_{fmt}"], port[f"ch_{fmt}_c64"]
    skip = 8 if fmt == "u8" else 0
    assert snr_db(Y_c[skip:], Y_w[skip:]) > 85.0


@pytest.mark.parametrize("fmt", ["i16", "u8"])
def test_tp_channelized_bank_wire_format_matches_converted(ring4, fmt):
    """The four-rank FM bank on raw wire input against the port's
    single-card ChannelizedBank on the converted values: the JAX test's
    bars (u8 60 dB on block 0 past 64 samples, then 85)."""
    data, _, port = ring4
    ns = C * 64 * 8
    cfg = ChannelizedBankConfig(channelizer=CH["tp6"], demod="fm", kd=0.25)
    ref = ChannelizedBank(cfg, ns, device="cpu")
    y_ref = np.concatenate([ref(torch.from_numpy(b)).numpy()
                            for b in split(data[f"bank_{fmt}_c64"], ns)], 1)
    m = ns // C
    y = port[f"bank_{fmt}"]
    for b, floor in enumerate((60.0, 85.0) if fmt == "u8" else (85.0, 85.0)):
        skip = 64 if (fmt == "u8" and b == 0) else 0
        for ch in (7, 40):
            got = snr_db(y_ref[ch, b * m + skip:(b + 1) * m], y[ch, b * m + skip:(b + 1) * m])
            assert got > floor, (fmt, b, ch, got)


def test_sharded_conv_engine_refused():
    """engine='conv' is not plumbed through the sharded front end: refused,
    not silently measured as 'shift'."""
    ccfg = ChannelizerConfig(nchan=64, taps_per_branch=8, engine="conv")
    with pytest.raises(NotImplementedError):
        ShardedChannelizer(ccfg, make_mesh(1, 1, "cpu"), 64 * 64, device="cpu")
    with pytest.raises(NotImplementedError):
        ShardedScanner(ChannelizedBankConfig(channelizer=ccfg), make_mesh(1, 1, "cpu"),
                       64 * 64, device="cpu")


def test_channel_layout_roundtrip():
    C1, C2 = 8, 16
    perm = channel_layout(C1, C2)
    assert sorted(perm) == list(range(C1 * C2))
    # layout position c1*C2 + c2 holds natural channel c2*C1 + c1
    assert perm[3 * C2 + 5] == 5 * C1 + 3


def test_sharded_channelizer_rules():
    mesh = make_mesh(1, 1, "cpu")
    with pytest.raises(ValueError, match="multiple of 64"):
        ShardedChannelizer(CH["tp8"], mesh, 64 * 100 + 1, device="cpu")
    with pytest.raises(ValueError, match="frame halo"):
        ShardedChannelizer(CH["tp8"], mesh, 64 * 4, device="cpu")
    with pytest.raises(ValueError, match="multiples of 1"):
        ShardedChannelizer(CH["tp8"], mesh, 64 * 64, c1=3, device="cpu")
    with pytest.raises(ValueError, match="unknown input_format"):
        ShardedChannelizer(CH["tp8"], mesh, 64 * 64, input_format="f32", device="cpu")
    sc = ShardedChannelizer(CH["tp8"], mesh, 64 * 64, input_format="u8", device="cpu")
    with pytest.raises(TypeError, match="expects \\(N, 2\\)"):
        sc(np.zeros(64 * 64, np.complex64))
