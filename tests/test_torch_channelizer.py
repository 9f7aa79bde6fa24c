"""The port's polyphase channelizer and channelized demod bank
(``tpudsp_torch.chains.channelizer``, on the CPU: the kernels' plain
versions) against tpudsp's on the same numpy-seeded input, at the sizes
of tests/test_channelizer.py (C = 8-64 channels, T = 4-12 taps a branch),
each of whose 14 tests has its twin here, and against float64 oracles
(``tests/oracle/bank_oracle.py``).

Bars (the CPU's figures beside each, in dB): channelize's Y against
tpudsp's >= 120 (c64 / i16 / u8, os 1 and 2, 'shift' and 'conv': 125.8-
142.7); the branch sum against a float64 evaluation of its framing
formula >= 120 (126.1-145.5; uint8 the lowest, its offset taken off after
the sum); the column carry against tpudsp's (f32 powers) >= 110 (132.8-
137.6) and against a float64 serial loop >= 120 (144.7-145.4); the FM
bank on its FM channels against tpudsp >= 90 (134.2-139.9) and against
the float64 oracle >= 100 (128.0-132.1); the coherent AM channels against
tpudsp's 'pallas' >= 80 and 'xla' >= 60 (112.8-116.4); i16 against c64
>= 90 (139.4-141.5), u8 block 0 >= 60 past its transient (86.7-103.7),
then >= 85 (138.2-141.8): tpudsp's own bars; 'conv' against 'shift' >=
110 (139.9-144.0); mixed rows against uniform banks >= 100 (127.9 up).
The FM audio is compared on FM carriers only: on a noise channel a one-ulp
difference can flip the discriminator across its branch cut.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import bank_oracle
from tests.util import snr_db
from tpudsp.chains import channelizer as jch
from tpudsp.kernels import iir as jiir
from tpudsp_torch import convert
from tpudsp_torch.chains import channelizer as tch
from tpudsp_torch.cuda import am_backend_scan as tscan
from tpudsp_torch.cuda import first_order, launch, pfb
from tpudsp_torch.design import iirdes
from tpudsp_torch.kernels import agc as tagc
from tpudsp_torch.kernels import am_backend as tab
from tpudsp_torch.kernels import ampmodem as tam
from tpudsp_torch.kernels import iir as tiir
from tpudsp_torch.kernels import pfb as kpfb


def _cfgs(**kw):
    """The same ChannelizerConfig for tpudsp and the port."""
    return jch.ChannelizerConfig(**kw), tch.ChannelizerConfig(**kw)


def _bank_cfgs(ch, **kw):
    return (jch.ChannelizedBankConfig(channelizer=jch.ChannelizerConfig(**ch), **kw),
            tch.ChannelizedBankConfig(channelizer=tch.ChannelizerConfig(**ch), **kw))


def _port_channelizer(cfg, n):
    return tch.Channelizer(cfg, block_len=n, device="cpu")


def _run_port_bank(cfg, blocks, fmt="c64", backend="xla"):
    bank = tch.ChannelizedBank(cfg, block_len=len(blocks[0]), backend=backend,
                               input_format=fmt, device="cpu")
    return torch.cat([bank(torch.from_numpy(b)) for b in blocks], 1).numpy(), bank


def _run_jax_bank(cfg, blocks, fmt="c64", backend="xla"):
    bank = jch.ChannelizedBank(cfg, block_len=len(blocks[0]), backend=backend,
                               input_format=fmt)
    return np.concatenate([np.asarray(bank(b)) for b in blocks], 1), bank


def _noise(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scale).astype(np.complex64)


def _wire(x, fmt, gain):
    """x as c64, or raw i16 / u8 at ``gain`` of full scale, and the c64 of
    the raw values."""
    if fmt == "c64":
        return x.astype(np.complex64), x.astype(np.complex64)
    v = np.stack([x.real, x.imag], 1)
    if fmt == "i16":
        w = np.round(v * 32767 * gain).astype(np.int16)
        return w, ((w[:, 0] + 1j * w[:, 1]) / 32767.0).astype(np.complex64)
    w = np.round(v * 127.5 * gain + 127.5).clip(0, 255).astype(np.uint8)
    return w, (((w[:, 0] - 127.5) + 1j * (w[:, 1] - 127.5)) / 127.5).astype(np.complex64)


def _fm_stations(C, iq_rate, n, stations, dev=25_000.0):
    t = np.arange(n)
    x = 0
    for c, f_msg in stations.items():
        m = np.sin(2 * np.pi * f_msg / iq_rate * t)
        x = x + np.exp(1j * (2 * np.pi * (c / C) * t
                             + 2 * np.pi * (dev / iq_rate) * np.cumsum(m)))
    return (x / len(stations)).astype(np.complex64)


def _peak_hz(a, rate):
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    return np.fft.rfftfreq(len(a), 1.0 / rate)[np.argmax(spec[3:]) + 3]


# --- channelize against tpudsp ---------------------------------------------

@pytest.mark.parametrize("engine", ["shift", "conv"])
@pytest.mark.parametrize("os_", [1, 2])
@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_channelize_matches_tpudsp(fmt, os_, engine):
    """Two blocks with the carried tail: Y >= 120 dB from tpudsp's (125.8-
    142.7 dB on the CPU), the carried tail equal to tpudsp's."""
    C, T = 64, 8
    cj, ct = _cfgs(nchan=C, taps_per_branch=T, iq_rate=6.4e6, oversample=os_,
                   cutoff_frac=0.55 if os_ == 1 else 0.95, engine=engine)
    Hj, sj = jch.build(cj, fmt)
    Ht, st = tch.build(ct, fmt, device="cpu")
    np.testing.assert_array_equal(Ht.numpy(), np.asarray(Hj))
    n = C * 256
    w, _ = _wire(_noise(2 * n, 0, 0.3), fmt, 0.5)
    fj = jch.channelize if fmt == "c64" else jch.channelize_i16
    ft = tch.channelize if fmt == "c64" else tch.channelize_i16
    for b in range(2):
        sj, Yj = fj(Hj, sj, w[b * n:(b + 1) * n], os=os_, engine=engine)
        st, Yt = ft(Ht, st, torch.from_numpy(w[b * n:(b + 1) * n]), os=os_, engine=engine)
        assert Yt.shape == (os_ * n // C, C) and Yt.dtype == torch.complex64
        assert snr_db(np.asarray(Yj), Yt.numpy()) >= 120.0
        np.testing.assert_array_equal(st.tail.numpy(), np.asarray(sj.tail))


@pytest.mark.parametrize("os_", [1, 2])
@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_branch_sum_vs_float64_framing(fmt, os_):
    """kernels/pfb.branch_accumulate against the framing formula u[m, p] =
    sum_t Ht[t, p] xfull[(m + os (T-1-t)) R + C-1-p] in float64 (the uint8
    offset 127.5 sum_t Ht[t, p] taken off): >= 120 dB (126.1-145.5); the
    wrapper on CPU tensors is the plain version and launches nothing."""
    C, T = 32, 6
    rng = np.random.default_rng(4)
    Ht = (rng.standard_normal((T, C)) / (T * C)).astype(np.float32)
    htail, n = (T - 1) * C + C - 1, 40 * C
    w, _ = _wire(_noise(htail + n, 5, 0.3), fmt, 0.5)
    tail, x = w[:htail], w[htail:]
    u = kpfb.branch_accumulate(torch.from_numpy(Ht), torch.from_numpy(tail),
                               torch.from_numpy(x), os_).numpy()
    xf = w.astype(np.complex128) if fmt == "c64" else w[:, 0] + 1j * w[:, 1].astype(np.float64)
    M, R = n * os_ // C, C // os_
    m, p = np.arange(M)[:, None], np.arange(C)[None, :]
    ref = sum(Ht[t].astype(np.float64) * xf[(m + os_ * (T - 1 - t)) * R + C - 1 - p]
              for t in range(T))
    if fmt == "u8":
        ref = ref - 127.5 * (1 + 1j) * Ht.astype(np.float64).sum(0)
    assert snr_db(ref, u) >= 120.0
    launches = pfb.branch_accumulate.launches
    u2 = pfb.branch_accumulate(torch.from_numpy(Ht), torch.from_numpy(tail),
                               torch.from_numpy(x), os_).numpy()
    assert np.array_equal(u2.view(np.uint32), u.view(np.uint32))
    assert pfb.branch_accumulate.launches == launches


# --- the column carry -------------------------------------------------------

COLUMN_COEFFS = {"deemph_100k": iirdes.deemphasis_coeffs(100_000.0),
                 "deemph_97k": iirdes.deemphasis_coeffs(97_656.25)}


@pytest.mark.parametrize("which", sorted(COLUMN_COEFFS))
def test_column_carry_vs_tpudsp_and_float64(which):
    """The plain first_order_apply_blocked_mc over (N, C) = (9000, 5) (nine
    of its tiles, the last ragged) from distinct carries: bit for bit the
    rows version on the transpose at the column entry's tile of
    COLS_TILE_BLOCKS blocks; >= 110 dB from tpudsp's _mc, whose (L, L)
    kernel comes from f32 powers (132.8-137.6 dB); >= 120 dB from a
    float64 serial loop (144.7-145.4 dB); the wrapper on CPU tensors is the plain
    version and launches nothing."""
    b0, a = COLUMN_COEFFS[which]
    rng = np.random.default_rng(6)
    n, C = 9000, 5
    x = (0.3 * rng.standard_normal((n, C)) + np.linspace(-1, 1, C)).astype(np.float32)
    y0 = np.array([0.0, 0.5, -1.0, 2.0, 0.1], np.float32)
    last, y = tiir.first_order_apply_blocked_mc(b0, a, torch.from_numpy(y0), torch.from_numpy(x))
    assert y.shape == (n, C) and last.shape == (C,)
    r_last, r_y = tiir.first_order_apply_blocked(b0, a, torch.from_numpy(y0),
                                                 torch.from_numpy(np.ascontiguousarray(x.T)),
                                                 tb=tiir.COLS_TILE_BLOCKS)
    assert torch.equal(y.T.contiguous().view(torch.int32), r_y.view(torch.int32))
    assert torch.equal(last.view(torch.int32), r_last.view(torch.int32))
    j_last, j_y = jiir.first_order_apply_blocked_mc(b0, a, jnp.asarray(y0), jnp.asarray(x))
    assert snr_db(np.asarray(j_y), y.numpy()) >= 110.0
    ref = np.empty((n, C))
    prev = y0.astype(np.float64)
    for k in range(n):
        prev = b0 * x[k].astype(np.float64) + a * prev
        ref[k] = prev
    assert snr_db(ref, y.numpy()) >= 120.0
    launches = first_order.first_order_apply_blocked_mc.launches
    w_last, w_y = first_order.first_order_apply_blocked_mc(b0, a, torch.from_numpy(y0),
                                                           torch.from_numpy(x))
    assert torch.equal(w_y, y) and torch.equal(w_last, last)
    assert first_order.first_order_apply_blocked_mc.launches == launches


def test_column_launch_refuses_cpu_tensors_and_scratch_grows():
    """The column carry's launch (first_order_scan_cols over (N, C)) needs a
    CUDA tensor; the stream's link scratch of the rows' launches grows to
    carries x C x tiles links (1 x 1024 x 2)."""
    tab = tiir.device_table(0.1, 0.9, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        first_order._launch_cols(tab, torch.zeros((16384, 1024)), torch.zeros(1024))
    scratch, _, _ = launch.chain(torch.device("cpu"), -1, 1024 * 2, 1024 * 2)
    assert scratch.numel() >= 4 + launch.LINK * 2048


# --- tests/test_channelizer.py's pins, on the port -------------------------

def test_tone_routing_and_rejection():
    C = 64
    cj, ct = _cfgs(nchan=C, taps_per_branch=8, iq_rate=6_400_000.0)
    n = C * 512
    t = np.arange(n)
    targets = [3, 17, C - 5]
    x = sum(np.exp(2j * np.pi * (c / C) * t) for c in targets).astype(np.complex64)
    Y = _port_channelizer(ct, n)(x).numpy()
    assert snr_db(np.asarray(jch.Channelizer(cj, block_len=n)(x)), Y) >= 120.0
    P = np.mean(np.abs(Y[32:]) ** 2, axis=0)
    for c in targets:
        assert P[c] > 0.5, (c, P[c])
    quiet = [c for c in range(C) if 1 < min(abs(c - tc) for tc in targets) < C - 1]
    assert 10 * np.log10(P[targets[0]] / max(P[q] for q in quiet)) > 50.0


def test_channel_passband_gain_and_offset_tone():
    C = 32
    _, ct = _cfgs(nchan=C, taps_per_branch=12, iq_rate=3_200_000.0)
    n = C * 1024
    c0, f_off = 5, 0.2 / C
    x = np.exp(2j * np.pi * (c0 / C + f_off) * np.arange(n)).astype(np.complex64)
    Y = _port_channelizer(ct, n)(x).numpy()[64:, c0]
    ref = np.exp(2j * np.pi * f_off * C * (np.arange(len(Y)) + 64))
    a = np.vdot(ref, Y) / np.vdot(ref, ref)
    assert abs(abs(a) - 1.0) < 0.1
    assert snr_db(a * ref, Y) > 40.0


@pytest.mark.parametrize("os_", [1, 2])
def test_block_invariance(os_):
    """One block against four quarter blocks with the carried tail (atol
    1e-4, the JAX package's pin; also its oversampled twin)."""
    C = 32
    _, ct = _cfgs(nchan=C, taps_per_branch=6, iq_rate=3_200_000.0, oversample=os_)
    n = C * 256
    x = _noise(n, os_ - 1)
    Y1 = _port_channelizer(ct, n)(x).numpy()
    ch = _port_channelizer(ct, n // 4)
    Y2 = np.concatenate([ch(x[i:i + n // 4]).numpy() for i in range(0, n, n // 4)], 0)
    np.testing.assert_allclose(Y1, Y2, atol=1e-4)


@pytest.fixture(scope="module")
def fm_bank_runs():
    """FM stations on channels 10 and 40 of 64 (os 1 and 2), one block
    through both packages, and the float64 oracle's audio."""
    C, iq_rate = 64, 6_400_000.0
    n = C * 4096
    stations = {10: 1000.0, 40: 2300.0}
    x = _fm_stations(C, iq_rate, n, stations)
    out = {}
    for os_, cf in ((1, 0.55), (2, 0.95)):
        chan_rate = iq_rate / C * os_
        cj, ct = _bank_cfgs(dict(nchan=C, taps_per_branch=8, iq_rate=iq_rate, oversample=os_,
                                 cutoff_frac=cf), demod="fm", kd=25_000.0 / chan_rate)
        yt, bank = _run_port_bank(ct, [x])
        yj, _ = _run_jax_bank(cj, [x])
        h = bank.params[0].numpy().astype(np.float64).reshape(-1)
        b0, a = iirdes.deemphasis_coeffs(chan_rate)
        ref = bank_oracle.fm_demod_f64(
            bank_oracle.channelizer_f64(x, h, C, os_, list(stations)).T, ct.kd, b0, a)
        out[os_] = (yt, yj, ref, stations, chan_rate, bank)
    return out


@pytest.mark.parametrize("os_", [1, 2])
def test_channelized_fm_bank(fm_bank_runs, os_):
    """The FM bank (the row-major fast path; also its oversampled twin):
    each station's tone in its row; its rows >= 90 dB from tpudsp's
    (134.2-139.9 dB) and >= 100 dB from the float64 oracle (128.0-132.1
    dB)."""
    yt, yj, ref, stations, chan_rate, bank = fm_bank_runs[os_]
    C = 64
    assert yt.shape == (C, os_ * 4096) and yt.dtype == np.float32
    assert bank.metrics.rssi is None and bank.metrics.squelch_modes is None
    for k, (c, f_msg) in enumerate(stations.items()):
        tail = yt[c, yt.shape[1] // 4:]
        assert abs(_peak_hz(tail, chan_rate) - f_msg) < 0.02 * chan_rate, (c, f_msg)
        assert snr_db(yj[c], yt[c]) >= 90.0
        assert snr_db(ref[k], yt[c]) >= 100.0


def test_fm_fast_path_is_one_column_launch_of_the_discriminator(monkeypatch):
    """bank_step's uniform-FM path is one cuda/first_order.fm_deemph_cols
    call a block (on the card one launch from the (M, C) channel matrix to
    the (C, M) audio rows), with (b0, a) from iirdes.deemphasis_coeffs,
    from the frame and de-emphasis state the block before carried; no f32
    column carry (first_order_apply_blocked_mc) runs on that path."""
    calls, f32_calls = [], []
    fused, mc = first_order.fm_deemph_cols, first_order.first_order_apply_blocked_mc

    def spy(*args):
        out = fused(*args)
        calls.append((args, out))
        return out

    def mc_spy(*args):
        f32_calls.append(args)
        return mc(*args)
    monkeypatch.setattr(first_order, "fm_deemph_cols", spy)
    monkeypatch.setattr(first_order, "first_order_apply_blocked_mc", mc_spy)
    C = 16
    _, ct = _bank_cfgs(dict(nchan=C, taps_per_branch=8, iq_rate=1.6e6), demod="fm")
    M = 40   # frames a block, no multiple of the 32 of a carry block
    x = _fm_stations(C, 1.6e6, 2 * C * M, {3: 1000.0})
    y, bank = _run_port_bank(ct, [x[:C * M], x[C * M:]])
    assert len(calls) == 2 and not f32_calls
    for (b0, a, kd, fd_prev, y_prev, Y), (fd_last, y_last, rows) in calls:
        assert (b0, a) == iirdes.deemphasis_coeffs(ct.channelizer.chan_rate) and kd == ct.kd
        assert Y.shape == (M, C) and Y.dtype == torch.complex64
        assert fd_prev.shape == (C,) and y_prev.shape == (C,) and rows.shape == (C, M)
        assert rows.is_contiguous()
        assert torch.equal(fd_last, Y[-1])
    (first, out0), (second, out1) = calls
    assert torch.equal(first[3], torch.full((C,), 1.0 + 0.0j, dtype=torch.complex64))
    assert torch.equal(first[4], torch.zeros(C))
    assert second[3] is out0[0] and second[4] is out0[1]
    assert bank.state.fd_prev is out1[0] and bank.state.deemph is out1[1]
    assert np.array_equal(y, torch.cat([out0[2], out1[2]], 1).numpy())


@pytest.fixture(scope="module")
def coherent_runs():
    """tests/test_channelizer.py's AM stations (channels 5 and 20 of 32,
    15 Hz off), the coherent back end at agc_bandwidth 0.05 (a short
    warmup keeps the plain front's loop short), streamed in halves; tpudsp's
    Pallas back end in interpret mode."""
    C, iq_rate = 32, 3_200_000.0
    n = C * 16384
    t = np.arange(n)
    stations = {5: 1000.0, 20: 2500.0}
    x = 0
    for c, f_msg in stations.items():
        m = np.sin(2 * np.pi * f_msg / iq_rate * t)
        x = x + (1 + 0.5 * m) * 0.4 * np.exp(2j * np.pi * ((c / C) + 15.0 / iq_rate) * t)
    x = (x / len(stations)).astype(np.complex64)
    cj, ct = _bank_cfgs(dict(nchan=C, taps_per_branch=8, iq_rate=iq_rate), demod="am",
                        am_coherent=True, agc_bandwidth=0.05)
    blocks = [x[:n // 2], x[n // 2:]]
    out = {f"jax_{b}": _run_jax_bank(cj, blocks, backend=b)[0] for b in ("xla", "pallas")}
    for b in ("kernel", "xla"):
        out[f"port_{b}"] = _run_port_bank(ct, blocks, backend=b)
    return out, stations, iq_rate / C


@pytest.mark.parametrize("port,jax_,bar", [("kernel", "pallas", 80.0), ("kernel", "xla", 60.0),
                                           ("xla", "xla", 60.0)])
def test_channelized_am_bank_coherent(coherent_runs, port, jax_, bar):
    """The AM stations DC-free, on their tones, >= the bar from tpudsp's
    (112.8-116.4 dB), with the block's metrics."""
    out, stations, chan_rate = coherent_runs
    audio, bank = out[f"port_{port}"]
    assert audio.shape == (32, 16384)
    for c, f_msg in stations.items():
        tail = audio[c, 3 * audio.shape[1] // 4:]
        assert abs(tail.mean()) < 0.05 * np.abs(tail).max(), (c, tail.mean())
        assert abs(_peak_hz(tail, chan_rate) - f_msg) < 0.02 * chan_rate, (c, f_msg)
        assert snr_db(out[f"jax_{jax_}"][c], audio[c]) >= bar
    m = bank.metrics
    assert m.squelch_modes.shape == (32, 8192) and m.pll_freq.shape == (32,)
    assert torch.all(torch.isfinite(m.rssi))


def _am_columns(L, C, seed):
    """C AM carriers a little off centre as the columns of a (L, C)
    complex64 channel matrix, in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)[:, None]
    m = 1 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.005, 0.02, C) * t)
    y = 0.3 * m * np.exp(2j * np.pi * rng.uniform(-0.002, 0.002, C) * t)
    y = y + 0.01 * (rng.standard_normal((L, C)) + 1j * rng.standard_normal((L, C)))
    return torch.from_numpy(y.astype(np.complex64))


def _coherent_params_state(C, seed):
    amb = tab.make_params(tagc.make_params(alpha=0.05, scale=1.0, device="cpu"), 1.0,
                          *iirdes.deemphasis_coeffs(97_656.25), carrier=True)
    g = torch.Generator().manual_seed(seed)
    agc = tagc.AgcState(*(v.expand(C).contiguous() for v in tagc.agc_init(device="cpu")))
    pll = tab.PllState((torch.rand(C, generator=g) - 0.5) * 2.0,
                       (torch.rand(C, generator=g) - 0.5) * 0.01)
    return amb, tab.FrontState(agc, pll)


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.is_floating_point():
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("L, C, chunk, warmup", [
    # cam's geometry scaled down (chunk = warmup, 5 chunks, the last one
    # padded by 2816 / 16384 of a block: here 704 of 4096), the warmup one
    # chunk, so a lane's window reaches back into the chunk before it
    (4096, 32, 960, 960),
    # a channel count that is no multiple of 32, a warmup spanning chunks
    (3000, 37, 700, 1500),
    # one chunk: the exact route
    (1500, 20, 1280, 1280),
])
def test_front_chunked_mc_ref_matches_front_chunked_ref_of_the_transpose(L, C, chunk, warmup):
    """The matrix entry's plain version (channel-minor lanes read from Y's
    columns) is front_chunked_ref of Y's transpose bit for bit: vr and
    modes (C, L) and every carried state leaf."""
    Y = _am_columns(L, C, L + C)
    amb, st = _coherent_params_state(C, C)
    got_front, got = tscan.front_chunked_mc(amb, st, Y, chunk, warmup)
    want_front, want = tscan.front_chunked_ref(amb, st, Y.T.contiguous(), chunk, warmup)
    for a, b in zip([*got_front.agc, *got_front.pll, *got],
                    [*want_front.agc, *want_front.pll, *want]):
        assert _same_bits(a, b)
    assert got[0].shape == (C, L) and got[1].dtype == torch.int32


def test_linear_tail_rows_matches_the_parent_row_scans():
    """cuda/first_order.linear_tail over C rows (the coherent bank's one
    launch) against the DC tracker's row scan, the eager audio line and the
    de-emphasis row scan it replaces: bit for bit on the CPU, and >= 120 dB
    from a float64 serial loop."""
    C, n = 24, 2 * tiir.TILE_BLOCKS * tiir.L_BLOCK + 77
    rng = np.random.default_rng(5)
    vr = torch.from_numpy((0.3 + 0.2 * rng.standard_normal((C, n))).astype(np.float32))
    dc0 = torch.from_numpy(rng.uniform(0.2, 0.4, C).astype(np.float32))
    de0 = torch.from_numpy(rng.uniform(-0.1, 0.1, C).astype(np.float32))
    amb, _ = _coherent_params_state(C, 0)
    (dc, de), pcm = first_order.linear_tail(amb, dc0, de0, vr)
    dc_p, dct = first_order.first_order_apply_blocked(1.0 - tam.DC_RHO, tam.DC_RHO, dc0, vr)
    de_p, pcm_p = first_order.first_order_apply_blocked(amb.deemph_b0, amb.deemph_a, de0,
                                                        (vr - dct) * amb.inv_mod)
    assert _same_bits(dc, dc_p) and _same_bits(de, de_p) and _same_bits(pcm, pcm_p)
    v, d, e = vr.double().numpy(), dc0.double().numpy(), de0.double().numpy()
    ref = np.empty((C, n))
    for k in range(n):
        d = tam.DC_RHO * d + (1.0 - tam.DC_RHO) * v[:, k]
        e = amb.deemph_b0 * (v[:, k] - d) + amb.deemph_a * e
        ref[:, k] = e
    assert snr_db(ref, pcm.numpy()) >= 120.0


def _parent_cam_step(params, state, x, cfg, backend):
    """bank_step's coherent route as it was on the (C, M) rows: Y's
    transpose, the planes front, the DC tracker's row scan, the eager audio
    line and the de-emphasis row scan."""
    plan = cfg.plan
    Ht, _, _, amb, _ = params
    ch, Y = tch._channelize(Ht, state.ch, x, cfg.channelizer.oversample,
                            cfg.channelizer.engine)
    Yc = Y.T.contiguous()
    front, (vr, modes) = tscan.front_chunked(amb, state.front, Yc, plan.chunk[backend],
                                             plan.warmup)
    dc, dct = first_order.first_order_apply_blocked(1.0 - tam.DC_RHO, tam.DC_RHO, state.dc, vr)
    deemph, audio = first_order.first_order_apply_blocked(*plan.deemph, state.deemph,
                                                          (vr - dct) * amb.inv_mod)
    return tch.DemodBankState(ch, Yc[:, -1].clone(), deemph, front, dc), (audio, modes)


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_cam_route_matches_the_parent_route(backend):
    """bank_step's 'cam' route (the matrix front on Y, one rows tail) against
    the parent's route over two blocks: the audio, the squelch modes (C, M),
    the metrics and every carried state leaf bit for bit ('xla': chunk 1280,
    a padded last chunk; 'kernel': chunk 1024, none)."""
    C, n = 16, 16 * 4096
    t = np.arange(2 * n)
    m = np.sin(2 * np.pi * 1000.0 / 1.6e6 * t)
    x = ((1 + 0.5 * m) * 0.4 * np.exp(2j * np.pi * (3 / C + 15.0 / 1.6e6) * t)
         + _noise(2 * n, 3, 0.05)).astype(np.complex64)
    _, ct = _bank_cfgs(dict(nchan=C, taps_per_branch=8, iq_rate=1.6e6), demod="am",
                       am_coherent=True, agc_bandwidth=0.05)
    assert ct.plan.route == "cam"
    params, state = tch.bank_build(ct, device="cpu")
    parent = state
    for b in range(2):
        xb = torch.from_numpy(x[b * n:(b + 1) * n])
        state, (audio, met) = tch.bank_step(params, state, xb, cfg=ct, backend=backend)
        parent, (p_audio, p_modes) = _parent_cam_step(params, parent, xb, ct, backend)
        assert audio.shape == (C, n // C) and met.squelch_modes.shape == (C, n // C)
        assert _same_bits(audio, p_audio) and _same_bits(met.squelch_modes, p_modes)
        assert _same_bits(met.pll_freq, parent.front.pll.freq)
        assert _same_bits(met.rssi, tch.kmet.rssi_db(parent.front.agc.g))
        got = [state.ch.tail, state.fd_prev, state.deemph, state.dc, *state.front.agc,
               *state.front.pll]
        want = [parent.ch.tail, parent.fd_prev, parent.deemph, parent.dc, *parent.front.agc,
                *parent.front.pll]
        for a, w in zip(got, want):
            assert _same_bits(a, w)


def test_oversampled_matches_bruteforce_oracle():
    """os = 2 against the direct filter-bank definition (atol 5e-5, the
    JAX package's pin) and against bank_oracle.channelizer_f64 (>= 120
    dB)."""
    C, T = 8, 4
    _, ct = _cfgs(nchan=C, taps_per_branch=T, iq_rate=1.0, oversample=2)
    Ht, st = tch.build(ct, device="cpu")
    h = Ht.numpy().reshape(-1).astype(np.float64)
    n = C * 16
    x = _noise(n, 3)
    _, Y = tch.channelize(Ht, st, torch.from_numpy(x), os=2)
    Y = Y.numpy()
    M, R = Y.shape[0], C // 2
    assert M == 2 * n // C
    want = np.zeros((M, C), np.complex128)
    for m in range(M):
        idx = m * R - np.arange(len(h))
        xs = np.where(idx >= 0, x[np.maximum(idx, 0)], 0)
        for c in range(C):
            want[m, c] = (np.sum(h * xs * np.exp(2j * np.pi * c * np.arange(len(h)) / C))
                          * np.exp(-2j * np.pi * c * m * R / C))
    np.testing.assert_allclose(Y, want, atol=5e-5)
    assert snr_db(bank_oracle.channelizer_f64(x, h, C, 2, range(C)), Y) >= 120.0


def test_oversampled_flat_passband_at_channel_edge():
    C = 32
    n = C * 2048
    c0, f_off = 5, 0.6 / C
    x = np.exp(2j * np.pi * (c0 / C + f_off) * np.arange(n)).astype(np.complex64)
    _, ct2 = _cfgs(nchan=C, taps_per_branch=12, iq_rate=3_200_000.0, oversample=2,
                   cutoff_frac=0.95)
    Y2 = _port_channelizer(ct2, n)(x).numpy()[128:, c0]
    ref = np.exp(2j * np.pi * f_off * (C // 2) * (np.arange(len(Y2)) + 128))
    a = np.vdot(ref, Y2) / np.vdot(ref, ref)
    assert abs(abs(a) - 1.0) < 0.05, abs(a)
    assert snr_db(a * ref, Y2) > 40.0
    _, ct1 = _cfgs(nchan=C, taps_per_branch=12, iq_rate=3_200_000.0)
    Y1 = _port_channelizer(ct1, n)(x).numpy()[64:, c0]
    assert np.sqrt(np.mean(np.abs(Y1) ** 2)) < 0.5


def _wire_stream(C, n):
    t = np.arange(2 * n)
    return sum(np.exp(1j * (2 * np.pi * (c / C) * t + 2 * np.pi * 0.05 / C * np.cumsum(
        np.sin(2 * np.pi * 0.0005 * (i + 1) * t)))) for i, c in enumerate((4, 19))) / 2


@pytest.mark.parametrize("fmt", ["i16", "u8"])
def test_channelized_bank_raw_matches_converted(fmt):
    """Raw int16 / uint8 wire blocks through the PFB against the c64 bank
    on their values, streamed, os 1 and 2, on the stations' channels: i16
    >= 90 dB; u8's block 0 >= 60 dB past its first 64 samples (the 127
    tail's transient), block 1 >= 85 dB (the JAX package's bars)."""
    C, n = 32, 32 * 2048
    w, c64 = _wire(_wire_stream(C, n), fmt, 0.5 if fmt == "i16" else 0.9)
    for os_, cf in ((1, 0.55), (2, 0.95)):
        _, ct = _bank_cfgs(dict(nchan=C, taps_per_branch=6, iq_rate=3_200_000.0,
                                oversample=os_, cutoff_frac=cf), demod="fm", kd=0.25)
        yc, _ = _run_port_bank(ct, [c64[:n], c64[n:]])
        yw, _ = _run_port_bank(ct, [w[:n], w[n:]], fmt)
        m = yc.shape[1] // 2
        for ch in (4, 19):
            if fmt == "i16":
                assert snr_db(yc[ch], yw[ch]) > 90.0, (os_, ch)
            else:
                assert snr_db(yc[ch, 64:m], yw[ch, 64:m]) > 60.0, (os_, ch)
                assert snr_db(yc[ch, m:], yw[ch, m:]) > 85.0, (os_, ch)


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_channelizer_conv_engine_matches_shift(fmt):
    """engine='conv' against 'shift' on the envelope-AM bank, os 1 and 2,
    streamed: >= 110 dB (the JAX package's bar)."""
    C, n = 32, 32 * 1024
    w, _ = _wire(_noise(2 * n, 11, 0.25), fmt, 0.9)
    for os_, cf in ((1, 0.55), (2, 0.95)):
        ys = {}
        for engine in ("shift", "conv"):
            _, ct = _bank_cfgs(dict(nchan=C, taps_per_branch=6, iq_rate=3_200_000.0,
                                    oversample=os_, cutoff_frac=cf, engine=engine), demod="am")
            ys[engine], _ = _run_port_bank(ct, [w[:n], w[n:]], fmt)
        assert snr_db(ys["shift"], ys["conv"]) > 110.0, (os_, fmt)


@pytest.mark.parametrize("coh", [False, True])
def test_channelized_bank_mixed_demod(coh):
    """Per-channel fm / am tuples: each mixed row matches the row of a
    uniform bank of its type on the same input (>= 100 dB), and the mixed
    bank matches tpudsp's on the envelope rows (>= 90 dB)."""
    C, n = 16, 16 * 2048
    x = _noise(n, 11, 0.1)
    ch = dict(nchan=C, taps_per_branch=8)
    demods = tuple("am" if i % 3 == 0 else "fm" for i in range(C))
    cj, ct = _bank_cfgs(ch, demod=demods, am_coherent=coh, agc_bandwidth=0.05)
    a_mix, _ = _run_port_bank(ct, [x], backend="kernel")
    for kind in ("fm", "am"):
        _, cu = _bank_cfgs(ch, demod=kind, am_coherent=coh, agc_bandwidth=0.05)
        a_u, _ = _run_port_bank(cu, [x], backend="kernel")
        rows = [i for i, d in enumerate(demods) if d == kind]
        assert snr_db(a_u[rows], a_mix[rows]) > 100.0, (kind, coh)
    if not coh:
        a_j, _ = _run_jax_bank(cj, [x])
        assert snr_db(a_j[[i for i, d in enumerate(demods) if d == "am"]],
                      a_mix[[i for i, d in enumerate(demods) if d == "am"]]) > 90.0


def test_channelized_bank_validation():
    """The configs' and the bank's errors, as tpudsp raises them."""
    ccfg = tch.ChannelizerConfig(nchan=8, taps_per_branch=8)
    with pytest.raises(ValueError):
        tch.ChannelizedBankConfig(channelizer=ccfg, demod=("fm",) * 7)
    with pytest.raises(ValueError):
        tch.ChannelizedBankConfig(channelizer=ccfg, demod=("fm",) * 7 + ("usb",))
    with pytest.raises(ValueError):
        tch.ChannelizedBankConfig(channelizer=ccfg, demod="usb")
    for bad in (dict(oversample=3), dict(nchan=7, oversample=2), dict(engine="fft")):
        with pytest.raises(ValueError):
            tch.ChannelizerConfig(**bad)
    cfg = tch.ChannelizedBankConfig(channelizer=ccfg)
    with pytest.raises(ValueError):
        tch.ChannelizedBank(cfg, block_len=12, device="cpu")
    with pytest.raises(ValueError):
        tch.ChannelizedBank(cfg, block_len=64, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        tch.build(ccfg, "f32", device="cpu")
    with pytest.raises(ValueError):
        tch.Channelizer(ccfg, block_len=12, device="cpu")
    bank = tch.ChannelizedBank(cfg, block_len=64, input_format="i16", device="cpu")
    with pytest.raises(TypeError):
        bank(np.zeros((64, 2), np.uint8))
    with pytest.raises(TypeError):
        bank(np.zeros(64, np.int16))


def test_channelized_bank_from_jax_carries_the_stream():
    """tpudsp runs block 1 of a mixed fm / coherent am bank,
    convert.channelized_bank_from_jax carries its params and state over,
    the port runs block 2: against tpudsp's block 2, the FM station's row
    >= 90 dB and the AM station's >= 60 dB (tpudsp's XLA back end's atan2
    against the port's patan2)."""
    C, iq_rate = 16, 1.6e6
    n = C * 2048
    t = np.arange(2 * n)
    m = np.sin(2 * np.pi * 1000.0 / iq_rate * t)
    x = (_fm_stations(C, iq_rate, 2 * n, {2: 700.0}, dev=5_000.0)
         + (1 + 0.5 * m) * 0.4 * np.exp(2j * np.pi * (9 / C + 10.0 / iq_rate) * t)
         ).astype(np.complex64)
    demods = tuple("am" if i == 9 else "fm" for i in range(C))
    cj, ct = _bank_cfgs(dict(nchan=C, taps_per_branch=8, iq_rate=iq_rate), demod=demods,
                        am_coherent=True, agc_bandwidth=0.05, kd=0.05)
    bank = jch.ChannelizedBank(cj, block_len=n)
    bank(x[:n])
    params, state = convert.channelized_bank_from_jax(bank.params, bank.state, device="cpu")
    y2j = np.asarray(bank(x[n:]))
    assert state.ch.tail.dtype == torch.complex64 and state.front.agc.g.shape == (1,)
    _, (y2t, _) = tch.bank_step(params, state, torch.from_numpy(x[n:]), cfg=ct)
    y2t = y2t.numpy()
    assert snr_db(y2j[2], y2t[2]) >= 90.0
    assert snr_db(y2j[9], y2t[9]) >= 60.0
    Ht, st = convert.channelizer_from_jax(*jch.build(cj.channelizer, "u8"), device="cpu")
    assert st.tail.dtype == torch.uint8 and st.tail.shape == (8 * 16 - 1, 2)
    assert torch.equal(Ht, tch.build(ct.channelizer, "u8", device="cpu")[0])
