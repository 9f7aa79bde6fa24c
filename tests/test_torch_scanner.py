"""The port's time-sharded wideband scanner (``parallel.ShardedScanner``,
BASELINE config 5's core, on CPU tensors: the plain versions of every
kernel) against the JAX package's on its 8-device CPU mesh, over two
streamed blocks with carried state; mirrors tests/test_scanner.py and the
scanner case of tests/test_stream_runtime.py (StreamRuntime pumping raw
uint8 bytes through the sharded scanner). The JAX scanner's parameters
and state, which every rank holds whole, are carried over with
``convert.scanner_from_jax``.

Rings of four time ranks run as spawned gloo processes
(tests/torch_ranks.py), every case of the file in one spawn (the
``ring4`` fixture); the one-rank mesh runs here. The coherent AM cases use
a faster AGC loop (bandwidth 0.05) to keep the plain front scan short.

Bars, on the occupied channels (an empty channel FM-demodulates
float-level residuals, or runs its AGC to the gain clamp): FM audio >=
90 dB from tpudsp (the bank's FM bar); coherent AM >= 60 dB from tpudsp
past the settling quarter (tpudsp's sharded back end is its XLA one: libm
atan2 where the port's front takes patan2); the port against its own
single-card ChannelizedBank >= 100 dB on a one-rank mesh (FM and AM) and
on four ranks (FM); wire formats against the c64 scanner on their values
at the JAX test's bars.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_sharded_am import jax_f32_powers
from tests.torch_ranks import run_ranks
from tests.util import snr_db
from tpudsp_torch import convert
from tpudsp_torch.chains.channelizer import (ChannelizedBank, ChannelizedBankConfig,
                                             ChannelizerConfig)
from tpudsp_torch.io import StreamRuntime
from tpudsp_torch.parallel import ShardedScanner, make_mesh
from tpudsp_torch.parallel import bank as pbank

C = 32
FS = 3_200_000.0
N = C * 2048
N_AM = C * 8192
FM = ChannelizedBankConfig(channelizer=ChannelizerConfig(nchan=C, taps_per_branch=6, iq_rate=FS),
                           demod="fm", kd=0.25)
OS2 = ChannelizedBankConfig(channelizer=ChannelizerConfig(nchan=C, taps_per_branch=6, iq_rate=FS,
                                                          oversample=2, cutoff_frac=0.95),
                            demod="fm", kd=0.25)
AM = ChannelizedBankConfig(channelizer=ChannelizerConfig(nchan=C, taps_per_branch=6, iq_rate=FS),
                           demod="am", am_coherent=True, agc_bandwidth=0.05)
MIXED = ChannelizedBankConfig(channelizer=ChannelizerConfig(nchan=16, taps_per_branch=8),
                              demod=tuple("am" if i % 3 == 0 else "fm" for i in range(16)),
                              am_coherent=True, agc_bandwidth=0.05)
FM_CHANS = (3, 11, 25)
PORT_POWERS = pbank._powers


def fm_iq(n, seed=0):
    t = np.arange(n)
    x = sum(np.exp(1j * (2 * np.pi * (c / C) * t + 2 * np.pi * 0.1 / C * np.cumsum(
        np.sin(2 * np.pi * 0.00037 * (i + 1 + seed) * t)))) for i, c in enumerate(FM_CHANS))
    return (x / 3).astype(np.complex64)


def am_iq(n):
    t = np.arange(n)
    x = sum((1 + 0.5 * np.sin(2 * np.pi * 0.0004 * (i + 1) * t)) * 0.4
            * np.exp(2j * np.pi * (c / C + 4e-6) * t) for i, c in enumerate(FM_CHANS))
    return (x / 3).astype(np.complex64)


def mixed_iq(n):
    """AM carriers on channels 3 and 9 (AM rows 0, 3, 6, 9, 12, 15), an FM
    carrier on 5, of 16 channels."""
    t = np.arange(n)
    x = sum((1 + 0.5 * np.sin(2 * np.pi * 0.0004 * (i + 1) * t)) * 0.4
            * np.exp(2j * np.pi * (c / 16 + 4e-6) * t) for i, c in enumerate((3, 9)))
    x = x + 0.4 * np.exp(1j * (2 * np.pi * 5 / 16 * t + 0.5 * np.sin(2 * np.pi * 0.0007 * t)))
    return (x / 3).astype(np.complex64)


def wire(x, fmt):
    if fmt == "i16":
        w = np.stack([np.round(x.real * 32767 * 0.5),
                      np.round(x.imag * 32767 * 0.5)], 1).astype(np.int16)
        return w, ((w[:, 0] + 1j * w[:, 1]) / 32767.0).astype(np.complex64)
    w = np.stack([np.round(x.real * 127.5 * 0.5 + 127.5),
                  np.round(x.imag * 127.5 * 0.5 + 127.5)], 1).clip(0, 255).astype(np.uint8)
    return w, ((w[:, 0] - 127.5) / 127.5 + 1j * (w[:, 1] - 127.5) / 127.5).astype(np.complex64)


def split(x, n):
    return [x[i:i + n] for i in range(0, len(x), n)]


def _jcfg(cfg):
    from tpudsp.chains import channelizer as jch
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["channelizer"] = jch.ChannelizerConfig(**dataclasses.asdict(cfg.channelizer))
    return jch.ChannelizedBankConfig(**kw)


def jax_run(cfg, T, block, blocks):
    """tpudsp's ShardedScanner on a (1, T) mesh: (its parameters and state
    as the port's CPU tensors, its audio over the blocks)."""
    from tpudsp.parallel import make_mesh as jmesh
    from tpudsp.parallel.multihost import ShardedScanner as J
    sc = J(_jcfg(cfg), jmesh(1, T), block_len=block)
    carried = convert.scanner_from_jax(sc.params, sc.state, device="cpu")
    return carried, np.concatenate([np.asarray(sc(b)) for b in blocks], 1)


def port_run(cfg, T, block, blocks, carried=None, jax_powers=False, **kw):
    """This rank's ShardedScanner over the blocks (every rank returns the
    whole audio)."""
    sc = ShardedScanner(cfg, make_mesh(1, T, "cpu"), block, device="cpu", **kw)
    if carried is not None:
        sc.params, sc.state = carried
    if jax_powers:
        pbank._powers = jax_f32_powers
    try:
        return torch.cat([sc(torch.from_numpy(b)) for b in blocks], 1).numpy()
    finally:
        pbank._powers = PORT_POWERS


def stream_u8(T):
    """StreamRuntime('uint8_raw') pumping two blocks of raw RTL-SDR bytes (an
    FM carrier on channel 5) through the scanner; (blocks processed, the
    audio)."""
    sc = ShardedScanner(FM, make_mesh(1, T, "cpu"), N, input_format="u8", device="cpu")
    t = np.arange(2 * N)
    x = 0.4 * np.exp(1j * (2 * np.pi * (5 / C) * t + 2 * np.pi * 0.03 / C * np.cumsum(
        np.sin(2 * np.pi * 0.001 * t))))
    raw = np.empty(2 * len(t), np.uint8)
    raw[0::2] = np.clip(np.round(x.real * 127.5 + 127.5), 0, 255)
    raw[1::2] = np.clip(np.round(x.imag * 127.5 + 127.5), 0, 255)
    blocks = []
    rt = StreamRuntime(sc, sample_format="uint8_raw",
                       on_audio=lambda a, meta: blocks.append(np.asarray(a)))
    rt.push(raw.tobytes())
    rt.stop(drain=True)
    return np.array([rt.blocks_processed]), np.concatenate(blocks, 1)


def _ring_rank(rank, world, tmp_path, cases):
    for name, args in cases.items():
        if name == "stream_u8":
            n_blocks, audio = stream_u8(world)
            np.save(tmp_path / f"{name}_n_{rank}.npy", n_blocks)
        else:
            cfg, block, blocks, carried, kw = args
            audio = port_run(cfg, world, block, blocks, carried, **kw)
        np.save(tmp_path / f"{name}_{rank}.npy", audio)


def ring_audio(tmp_path, world, cases):
    run_ranks(tmp_path, world, _ring_rank, tmp_path, cases, timeout=240.0)
    out = {}
    for name in cases:
        ys = [np.load(tmp_path / f"{name}_{r}.npy") for r in range(world)]
        for y in ys[1:]:
            np.testing.assert_array_equal(y, ys[0])
        out[name] = ys[0]
    out["stream_u8_blocks"] = int(np.load(tmp_path / "stream_u8_n_0.npy")[0])
    return out


# name: (config, block, signal) of the four-rank cases held against tpudsp
JAX_CASES = {"fm": (FM, N, "fm"), "os2": (OS2, N, "fm"), "am": (AM, N_AM, "am"),
             "mixed": (MIXED, 16 * 8 * 4096, "mixed")}


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    sig = {"fm": fm_iq, "am": am_iq, "mixed": mixed_iq}
    jax_out, cases, data = {}, {}, {}
    for name, (cfg, block, s) in JAX_CASES.items():
        blocks = split(sig[s](2 * block), block)
        carried, jax_out[name] = jax_run(cfg, 4, block, blocks)
        cases[name] = (cfg, block, blocks, carried, dict(jax_powers=cfg.am_coherent))
    data["stream"] = fm_iq(2 * N, seed=1)
    cases["stream"] = (FM, N, split(data["stream"], N), None, {})
    for fmt in ("i16", "u8"):
        w, c = wire(fm_iq(2 * N, seed=7), fmt)
        cases[f"wire_{fmt}"] = (FM, N, split(w, N), None, dict(input_format=fmt))
        cases[f"wire_{fmt}_c64"] = (FM, N, split(c, N), None, {})
    cases["stream_u8"] = None
    return data, jax_out, ring_audio(tmp_path_factory.mktemp("ring4"), 4, cases)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_scanner_matches_jax(ring4, name):
    """Four time ranks against tpudsp's four-shard scanner: the FM bank,
    os = 2, coherent AM and a mixed fm / coherent am bank (its AM rows a
    static subgroup on every rank)."""
    _, jax_out, port = ring4
    y_j, y = jax_out[name], port[name]
    assert y.shape == y_j.shape and np.all(np.isfinite(y))
    settle = y.shape[1] // 4
    if name in ("fm", "os2"):
        checks = [(c, 0, 90.0) for c in FM_CHANS]
    elif name == "am":
        checks = [(c, settle, 60.0) for c in FM_CHANS]
    else:
        checks = [(3, settle, 60.0), (9, settle, 60.0), (5, settle, 90.0)]
    for c, skip, bar in checks:
        s = snr_db(y_j[c, skip:], y[c, skip:])
        print(f"{name} ch {c}: {s:.2f} dB")
        assert s >= bar


@pytest.mark.parametrize("cfg,block", [(FM, N), (AM, C * 2048)])
def test_one_rank_mesh_matches_jax_and_channelized_bank(cfg, block):
    """The one-rank scanner against tpudsp's one-shard scanner and the
    port's single-card ChannelizedBank (its default 'xla' chunk), two
    blocks: the same launches but for the de-emphasis (and DC tracker),
    whose entry values are added after a zero-entry scan."""
    blocks = split(fm_iq(2 * block) if cfg is FM else am_iq(2 * block), block)
    carried, y_j = jax_run(cfg, 1, block, blocks)
    y = port_run(cfg, 1, block, blocks, carried, jax_powers=cfg.am_coherent)
    ref = ChannelizedBank(cfg, block, device="cpu")
    y_ref = np.concatenate([ref(torch.from_numpy(b)).numpy() for b in blocks], 1)
    y_own = port_run(cfg, 1, block, blocks)
    settle = 0 if cfg is FM else y.shape[1] // 4
    for c in FM_CHANS:
        s_j = snr_db(y_j[c, settle:], y[c, settle:])
        s_r = snr_db(y_ref[c, settle:], y_own[c, settle:])
        print(f"one rank ch {c}: tpudsp {s_j:.2f} dB, ChannelizedBank {s_r:.2f} dB")
        assert s_j >= (90.0 if cfg is FM else 60.0) and s_r >= 100.0


def test_scanner_streaming_matches_one_block(ring4):
    """Two blocks on four time ranks against the single-card
    ChannelizedBank over one block of twice the length."""
    data, _, port = ring4
    x = data["stream"]
    y_ref = ChannelizedBank(FM, len(x), device="cpu")(torch.from_numpy(x)).numpy()
    for c in FM_CHANS:
        assert snr_db(y_ref[c], port["stream"][c]) >= 100.0


@pytest.mark.parametrize("fmt", ["i16", "u8"])
def test_scanner_wire_format_matches_converted(ring4, fmt):
    """input_format 'i16' / 'u8' on four time ranks (the boundary halo at
    wire width) against the c64 scanner on the converted values: i16 >=
    90 dB, u8 60 dB on block 0 past 64 samples (the tail starts at 127)
    and 85 dB on block 1."""
    _, _, port = ring4
    y_w, y_c = port[f"wire_{fmt}"], port[f"wire_{fmt}_c64"]
    m = N // C
    for ch in FM_CHANS:
        if fmt == "i16":
            assert snr_db(y_c[ch], y_w[ch]) > 90.0
        else:
            assert snr_db(y_c[ch, 64:m], y_w[ch, 64:m]) > 60.0
            assert snr_db(y_c[ch, m:], y_w[ch, m:]) > 85.0


def test_stream_runtime_drives_sharded_scanner_from_wire_bytes(ring4):
    """StreamRuntime('uint8_raw') on every rank of the four-rank scanner:
    raw RTL-SDR bytes -> the ring -> the sharded step -> on_audio; the
    FM carrier's tone in channel 5, every rank the same audio."""
    _, _, port = ring4
    assert port["stream_u8_blocks"] == 2
    audio = port["stream_u8"]
    assert np.isfinite(audio).all()
    ch5 = audio[5, audio.shape[1] // 2:]
    spec = np.abs(np.fft.rfft((ch5 - ch5.mean()) * np.hanning(len(ch5))))
    peak = np.fft.rfftfreq(len(ch5), C / FS)[np.argmax(spec)]
    assert abs(peak - 0.001 * FS) < 0.02 * FS / C, peak


def test_scanner_rules():
    mesh = make_mesh(1, 1, "cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        ShardedScanner(FM, mesh, N + 1, device="cpu")
    with pytest.raises(ValueError, match="unknown input_format"):
        ShardedScanner(FM, mesh, N, input_format="f32", device="cpu")
    sc = ShardedScanner(FM, mesh, N, input_format="i16", device="cpu")
    with pytest.raises(TypeError, match="expects \\(N, 2\\)"):
        sc(np.zeros(N, np.complex64))
    with pytest.raises(ValueError, match="expected block"):
        sc(np.zeros((N - C, 2), np.int16))
