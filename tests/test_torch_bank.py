"""The port's receiver bank (``tpudsp_torch.chains.bank``, on the CPU: the
kernels' plain versions) against
tpudsp's ``ReceiverBank`` on the same numpy-seeded input, C <= 4 channels
over blocks of 50,000 samples, and against the float64 FM-bank oracle
(``tests/oracle/bank_oracle.py``).

Bars (SNR over the audio after the first 50 samples of each channel):
>= 90 dB for the FM, envelope-AM and SSB channels, in c64, i16 and u8;
the coherent AM channels >= 80 dB against tpudsp's Pallas back end (run
in interpret mode: the same patan2, chunk and warmup as the port's
'kernel' back end) and >= 60 dB against its XLA back end (libm atan2:
the JAX package's own pallas-vs-xla bar, tests/test_bank_am.py:90-101).
The FM channels are compared on FM carriers only: on noise a one-ulp
difference in the baseband can flip the discriminator across its branch
cut (noise-only channels are compared before the discriminator).
"""

import numpy as np
import pytest
import torch

from tests.oracle import bank_oracle
from tests.util import snr_db
from tpudsp.chains import bank as jbank
from tpudsp_torch import convert
from tpudsp_torch.chains import bank as tbank
from tpudsp_torch.cuda import halo_async
from tpudsp_torch.design import firdes, iirdes
from tpudsp_torch.kernels import decimate as tdec

FS = 2_400_000.0
N = 50_000            # samples a block: 5000 at the channel rate, 1000 audio
SKIP = 50             # audio samples left out of each comparison
DEV = 75_000.0 / 4    # FM deviation of the test carriers (Hz)
FREQS = (-500_000.0, -150_000.0, 200_000.0, 450_000.0)
KD = DEV / (FS / 10)


def _fm(n, fc, f_msg, amp, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    ph = 2 * np.pi * np.cumsum(fc / FS + DEV / FS * np.sin(2 * np.pi * f_msg / FS * t))
    return amp * np.exp(1j * (ph + rng.uniform(0, 2 * np.pi)))


def _ssb_tone(n, fc, df, amp=0.3):
    return amp * np.exp(2j * np.pi * (fc + df) / FS * np.arange(n))


def _am(n, fc, df, f_msg, amp=0.3):
    t = np.arange(n)
    return (1 + 0.5 * np.sin(2 * np.pi * f_msg / FS * t)) * amp * np.exp(
        2j * np.pi * (fc + df) / FS * t)


def _fm_stream(n, seed=0):
    """An FM carrier at the centre of each of the four channels."""
    x = sum(_fm(n, fc, 700.0 + 600.0 * k, 0.2, seed + k) for k, fc in enumerate(FREQS))
    return x + 0.001 * (np.random.default_rng(seed + 9).standard_normal((n, 2)) @ [1, 1j])


def _cfgs(demod, freqs=None, **kw):
    """The same BankConfig for tpudsp and the port."""
    if freqs is None:
        freqs = FREQS[:len(demod)] if isinstance(demod, tuple) else FREQS
    args = dict(freqs=freqs, iq_rate=FS, demod=demod, kd=KD, **kw)
    return jbank.BankConfig(**args), tbank.BankConfig(**args)


def _wire(x, fmt):
    """(c64 of the wire values, wire block) for fmt 'c64' / 'i16' / 'u8'."""
    if fmt == "c64":
        x = x.astype(np.complex64)
        return x, x
    if fmt == "i16":
        w = np.clip(np.round(np.stack([x.real, x.imag], 1) * 32767), -32767, 32767).astype(np.int16)
        return ((w[:, 0] + 1j * w[:, 1]) / 32767.0).astype(np.complex64), w
    w = np.clip(np.round(np.stack([x.real, x.imag], 1) * 127.5 + 127.5), 0, 255).astype(np.uint8)
    return (((w[:, 0] - 127.5) + 1j * (w[:, 1] - 127.5)) / 127.5).astype(np.complex64), w


def _run_jax(cfg, blocks, fmt="c64", backend="xla"):
    rx = jbank.ReceiverBank(cfg, block_len=len(blocks[0]), backend=backend,
                            input_format=fmt)
    return np.concatenate([np.asarray(rx(b)) for b in blocks], 1), rx


def _run_port(cfg, blocks, fmt="c64", backend="kernel"):
    rx = tbank.ReceiverBank(cfg, block_len=len(blocks[0]), backend=backend,
                            input_format=fmt, device="cpu")
    return torch.cat([rx(torch.from_numpy(b)) for b in blocks], 1).numpy(), rx


def _blocks(x, nblocks=2, n=N):
    return [x[k * n:(k + 1) * n] for k in range(nblocks)]


def _snrs(ref, y, skip=SKIP):
    return [snr_db(ref[c, skip:], y[c, skip:]) for c in range(ref.shape[0])]


def _oracle(cfg_t, x, params):
    h1 = firdes.kaiser_lowpass(cfg_t.taps1, 0.45 / cfg_t.decim1, 60.0)
    h2 = firdes.kaiser_lowpass(cfg_t.taps2, 0.45 / cfg_t.decim2, 60.0)
    b0, a = iirdes.deemphasis_coeffs(cfg_t.audio_rate)
    return bank_oracle.fm_bank_f64(x, params.dtheta.numpy(), h1, h2, cfg_t.decim1,
                                   cfg_t.decim2, cfg_t.kd, b0, a)


@pytest.fixture(scope="module")
def fm_runs():
    """The FM bank over two blocks in each wire format, both packages."""
    x = _fm_stream(2 * N) * 0.6
    cj, ct = _cfgs("fm")
    out = {}
    for fmt in ("c64", "i16", "u8"):
        xc, w = _wire(x, fmt)
        out[fmt] = (_run_jax(cj, _blocks(w), fmt)[0], _run_port(ct, _blocks(w), fmt), xc)
    return out


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_fm_bank_matches_tpudsp(fm_runs, fmt):
    yj, (yt, rx), _ = fm_runs[fmt]
    assert yt.shape == yj.shape == (4, 2 * N // 50) and yt.dtype == np.float32
    s = _snrs(yj, yt)
    assert min(s) >= 90.0, s
    assert rx.metrics.rssi is None and rx.metrics.squelch_modes is None


def test_fm_bank_vs_float64_oracle(fm_runs):
    """The port against the float64 oracle within 1 dB of tpudsp's own
    figure, channel by channel (both 113-118 dB on the CPU: the f32 front
    end's rounding, amplified by the discriminator), and >= 100 dB."""
    yj, (yt, rx), xc = fm_runs["c64"]
    ref = _oracle(rx.cfg, xc, rx.params)
    sj, st = _snrs(ref, yj), _snrs(ref, yt)
    assert all(abs(a - b) <= 1.0 for a, b in zip(sj, st)), (sj, st)
    assert min(st) >= 100.0, st


@pytest.mark.parametrize("fmt", ["i16", "u8"])
def test_fm_bank_wire_matches_converted(fm_runs, fmt):
    """Raw wire blocks against the c64 bank on the dequantized samples, the
    JAX package's bars: i16 >= 90 dB (tests/test_bank_am.py:132-157); u8
    block 0 >= 60 dB after its first 32 audio samples (the tail starts at
    127, half an LSB off zero), block 1 >= 85 dB."""
    _, (yw, _), xc = fm_runs[fmt]
    cj, ct = _cfgs("fm")
    yc, _ = _run_port(ct, _blocks(xc))
    m = N // 50
    if fmt == "i16":
        assert snr_db(yc, yw) > 90.0
    else:
        assert snr_db(yc[:, 32:m], yw[:, 32:m]) > 60.0
        assert snr_db(yc[:, m:], yw[:, m:]) > 85.0


def test_kernel_engine_u8_centring_vs_conv_engine(fm_runs):
    """The bank's front end (csrc/halo_async.cu, here its plain version
    cfir_ref) centres u8 samples by 127.5 on load, where the JAX package's
    conv engine (and the port's strided_cfir_conv_u8) subtracts the offset
    as a per-channel DC term after the product: equal in exact arithmetic,
    rounded differently. Held at the JAX package's raw-vs-converted bars
    (tests/test_bank_am.py:193-197: block 0 >= 60 dB past its first 32
    audio samples, block 1 >= 85 dB), on the front end's output over two
    blocks and on the audio against tpudsp's conv-engine bank."""
    yj, (yt, rx), _ = fm_runs["u8"]
    m = N // 50
    assert snr_db(yj[:, 32:m], yt[:, 32:m]) > 60.0
    assert snr_db(yj[:, m:], yt[:, m:]) > 85.0
    _, w = _wire(_fm_stream(2 * N) * 0.6, "u8")
    tw = torch.from_numpy(w)
    tail = torch.full((127, 2), 127, dtype=torch.uint8)
    p = rx.params
    y_kern = halo_async.cfir(tw, tail, p.taps_re, p.taps_im, 10, 2 * N // 10).numpy()
    y_conv = tdec.strided_cfir_conv_u8(torch.cat([tail, tw]), p.taps_re, p.taps_im, 10,
                                       2 * N // 10).numpy()
    m1 = N // 10
    assert snr_db(y_conv[:, 5 * 32:m1], y_kern[:, 5 * 32:m1]) > 60.0
    assert snr_db(y_conv[:, m1:], y_kern[:, m1:]) > 85.0


def test_fm_bank_streaming_invariance():
    """Two blocks against one block of double length (> 60 dB, the JAX
    package's pin, tests/test_chains.py:100-111)."""
    x = (_fm_stream(2 * N, seed=3) * 0.6).astype(np.complex64)
    ct = _cfgs("fm")[1]
    y2, _ = _run_port(ct, _blocks(x))
    y1, _ = _run_port(ct, [x])
    assert y1.shape == y2.shape
    assert snr_db(y1[:, 10:], y2[:, 10:]) > 60.0


def test_noise_bank_front_matches_tpudsp():
    """On noise the discriminator is not compared (a branch-cut flip is a
    2 pi jump in one sample); the baseband y1 before it is, over two blocks
    with carried tails and phase lattice: >= 100 dB."""
    rng = np.random.default_rng(5)
    x = (0.3 * (rng.standard_normal(2 * N) + 1j * rng.standard_normal(2 * N))).astype(np.complex64)
    cj, ct = _cfgs("am")
    jp, js = jbank.build(cj)
    tp, ts = tbank.build(ct, device="cpu")
    ys_j, ys_t = [], []
    for b in _blocks(x):
        js, (aj, _) = jbank.bank_step(jp, js, b, cfg=cj)
        ts, (at, _) = tbank.bank_step(tp, ts, torch.from_numpy(b), cfg=ct)
        ys_j.append(np.asarray(aj))
        ys_t.append(at.numpy())
    # envelope AM: |y1| decimated, so the front end and rotation are held
    assert min(_snrs(np.concatenate(ys_j, 1), np.concatenate(ys_t, 1))) >= 90.0
    y1j = jbank.kdec.strided_cfir(np.concatenate([np.zeros(127, np.complex64), x[:N]]),
                                  jp.taps_re, jp.taps_im, 10, N // 10)
    y1t = halo_async.cfir(torch.from_numpy(x[:N]), torch.zeros(127, dtype=torch.complex64),
                          tp.taps_re, tp.taps_im, 10, N // 10)
    assert snr_db(np.asarray(y1j), y1t.numpy()) >= 100.0


_PORT_FRONTS = {
    "conv": {"c64": tdec.strided_cfir_conv, "i16": tdec.strided_cfir_conv_i16,
             "u8": tdec.strided_cfir_conv_u8},
    "wide": {"c64": tdec.strided_cfir_matmul_wide, "i16": tdec.strided_cfir_matmul_wide_i16,
             "u8": tdec.strided_cfir_matmul_wide_u8},
    # the bank's front end: [halo | x], the first 127 samples as the halo
    "kernel": {f: lambda X, *a: halo_async.cfir(X[127:], X[:127], *a)
               for f in ("c64", "i16", "u8")},
}


@pytest.mark.parametrize("engine,fmt", [(e, f) for e in ("conv", "wide", "kernel")
                                        for f in ("c64", "i16", "u8")])
def test_front_engines_match_tpudsp(engine, fmt):
    """Each form of the port's strided complex FIR (the JAX package's conv
    and wide forms, and the bank's front end cuda/halo_async.cfir, on CPU
    tensors its plain version, which centres u8 on load) against tpudsp's
    conv engine on the same wire samples: >= 110 dB."""
    rng = np.random.default_rng(11)
    cj, ct = _cfgs("fm")
    jp, _ = jbank.build(cj, fmt)
    tp, _ = tbank.build(ct, fmt, device="cpu")
    x = 0.5 * (rng.standard_normal(20_127) + 1j * rng.standard_normal(20_127))
    _, w = _wire(x, fmt)
    nj = 2000
    ref = np.asarray(jbank.kdec.strided_cfir(w, jp.taps_re, jp.taps_im, 10, nj, engine="conv"))
    y = _PORT_FRONTS[engine][fmt](torch.from_numpy(w), tp.taps_re, tp.taps_im, 10, nj)
    assert y.shape == (4, nj) and y.dtype == torch.complex64
    assert snr_db(ref, y.numpy()) >= 110.0


def test_bank_front_is_one_cfir_call_a_block(monkeypatch):
    """bank_step's front end is one cuda/halo_async.cfir call a block, with
    the block as x and the carried 127-sample input tail as the halo; on
    CPU tensors it launches no kernel."""
    calls = []
    cfir = halo_async.cfir

    def spy(*args):
        calls.append(args)
        return cfir(*args)
    monkeypatch.setattr(halo_async, "cfir", spy)
    x = (_fm_stream(2 * N, seed=6) * 0.6).astype(np.complex64)
    launches = halo_async._launch.launches
    _run_port(_cfgs("fm")[1], _blocks(x))
    assert len(calls) == 2 and halo_async._launch.launches == launches
    for k, (xb, halo, *_rest, D1, nj) in enumerate(calls):
        np.testing.assert_array_equal(xb.numpy(), x[k * N:(k + 1) * N])
        want = np.zeros(127, np.complex64) if k == 0 else x[N - 127:N]
        np.testing.assert_array_equal(halo.numpy(), want)
        assert (D1, nj) == (10, N // 10)


def test_single_card_halo_entry_is_its_plain_version_on_cpu():
    """cuda/halo_async.cfir on CPU tensors is cfir_ref: the halo read as
    the prefix of [halo | x]."""
    rng = np.random.default_rng(2)
    _, ct = _cfgs("fm")
    tp, _ = tbank.build(ct, device="cpu")
    x = torch.from_numpy((rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(np.complex64))
    y = halo_async.cfir(x[127:], x[:127], tp.taps_re, tp.taps_im, 10, 487)
    ref = tdec.strided_cfir_matmul_wide(x, tp.taps_re, tp.taps_im, 10, 487)
    assert snr_db(ref.numpy(), y.numpy()) >= 120.0


@pytest.fixture(scope="module")
def coherent_runs():
    """Two coherent AM channels (AGC alpha 0.05 keeps the plain front's
    loop short), two blocks; tpudsp's Pallas back end in interpret mode."""
    x = (_am(2 * N, FREQS[0], 30.0, 1000.0) + _am(2 * N, FREQS[1], -20.0, 2000.0)
         ).astype(np.complex64)
    cj, ct = _cfgs("am", FREQS[:2], am_coherent=True, agc_bandwidth=0.05)
    out = {f"jax_{b}": _run_jax(cj, _blocks(x), backend=b)[0] for b in ("xla", "pallas")}
    for b in ("kernel", "xla"):
        out[f"port_{b}"] = _run_port(ct, _blocks(x), backend=b)
    return out


@pytest.mark.parametrize("port,jax_,bar", [("kernel", "pallas", 80.0), ("kernel", "xla", 60.0),
                                           ("xla", "xla", 60.0)])
def test_coherent_am_bank_matches_tpudsp(coherent_runs, port, jax_, bar):
    y, rx = coherent_runs[f"port_{port}"]
    s = _snrs(coherent_runs[f"jax_{jax_}"], y)
    assert min(s) >= bar, s
    m = rx.metrics
    assert m.squelch_modes.shape == (2, 2 * N // 10 // 2) and m.pll_freq.shape == (2,)
    assert torch.all(m.squelch_modes == 7) and torch.all(torch.isfinite(m.rssi))


def test_envelope_am_bank_matches_tpudsp():
    x = (_am(2 * N, FREQS[0], 0.0, 1000.0) + _am(2 * N, FREQS[2], 0.0, 2000.0)
         ).astype(np.complex64)
    cj, ct = _cfgs("am")
    s = _snrs(_run_jax(cj, _blocks(x))[0], _run_port(ct, _blocks(x))[0])
    assert min(s[0], s[2]) >= 90.0, s


@pytest.mark.parametrize("side", ["usb", "lsb"])
def test_ssb_bank_selects_sideband(side):
    """Two channels on one carrier, usb and lsb: the port matches tpudsp
    (>= 90 dB) and a single-sideband tone shows only in the matching
    channel (> 30 dB, tests/test_bank_ssb.py:37-54)."""
    fc, f_msg = 300_000.0, 2000.0
    x = _ssb_tone(2 * N, fc, f_msg if side == "usb" else -f_msg).astype(np.complex64)
    cj, ct = _cfgs(("usb", "lsb"), (fc, fc))
    yj, _ = _run_jax(cj, _blocks(x))
    yt, _ = _run_port(ct, _blocks(x))
    c = 0 if side == "usb" else 1
    assert snr_db(yj[c, SKIP:], yt[c, SKIP:]) >= 90.0
    settle = yt.shape[1] // 4
    band = lambda a: _band_power(a[settle:], f_msg)
    assert 10 * np.log10(band(yt[c]) / band(yt[1 - c])) > 30.0


def _band_power(a, f0, fs=48_000.0, halfwidth=60.0):
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    f = np.fft.rfftfreq(len(a), 1 / fs)
    return spec[(f > f0 - halfwidth) & (f < f0 + halfwidth)].sum()


def test_ssb_bank_streaming_invariance():
    fc = 300_000.0
    x = (_ssb_tone(2 * N, fc, 1500.0) + _ssb_tone(2 * N, fc, -2500.0)).astype(np.complex64)
    ct = _cfgs(("usb", "lsb"), (fc, fc))[1]
    y2, _ = _run_port(ct, _blocks(x))
    y1, _ = _run_port(ct, [x])
    assert snr_db(y1, y2) > 60.0


def _mixed_stream(n):
    return (_fm(n, FREQS[0], 1500.0, 0.3, 1) + _am(n, FREQS[1], 20.0, 2000.0)
            + _ssb_tone(n, FREQS[2], 1200.0) + _ssb_tone(n, FREQS[3], -900.0)
            ).astype(np.complex64)


def test_mixed_bank_matches_tpudsp():
    """fm / coherent am / usb / lsb in one bank: the masks select per
    channel, the AM channel is overwritten by the coherent back end."""
    x = _mixed_stream(2 * N)
    cj, ct = _cfgs(("fm", "am", "usb", "lsb"), am_coherent=True, agc_bandwidth=0.05)
    yj, _ = _run_jax(cj, _blocks(x), backend="pallas")
    yt, _ = _run_port(ct, _blocks(x))
    s = _snrs(yj, yt)
    assert min(s[0], s[2], s[3]) >= 90.0 and s[1] >= 80.0, s


def test_bank_from_jax_carries_the_stream():
    """tpudsp runs two blocks, convert.bank_from_jax carries its params and
    state over, the port runs the third: against tpudsp's third, the FM
    and SSB channels >= 90 dB, the coherent AM one >= 60 dB (the XLA back
    end's atan2 against the port's patan2)."""
    x = _mixed_stream(3 * N)
    cj, ct = _cfgs(("fm", "am", "usb", "lsb"), am_coherent=True, agc_bandwidth=0.05)
    _, jr = _run_jax(cj, _blocks(x, 2))
    params, state = convert.bank_from_jax(jr.params, jr.state, device="cpu")
    y3j = np.asarray(jr(x[2 * N:]))
    assert state.n0.dtype == torch.int64 and int(state.n0) == 2 * N
    assert params.dtheta.dtype == torch.int64
    np.testing.assert_array_equal(params.dtheta.numpy(), np.asarray(jr.params.dtheta))
    state, (y3t, _) = tbank.bank_step(params, state, torch.from_numpy(x[2 * N:]), cfg=ct,
                                      backend="xla")
    s = _snrs(y3j, y3t.numpy(), skip=0)
    assert min(s[0], s[2], s[3]) >= 90.0 and s[1] >= 60.0, s
    # the port's own build: every design array equal to tpudsp's
    tp, ts = tbank.build(ct, device="cpu")
    jp, js = jbank.build(cj)
    for f in ("taps_re", "taps_im", "dtheta", "h2", "fm_mask", "ssb_mask", "h2s_re",
              "h2s_im", "lsb_sign"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), f)


def test_phase_lattice_across_the_n0_wrap():
    """n0 half a block short of 2^32: the block crosses the wrap. The port's lattice equals the uint32 one exactly, and
    the bank's audio matches tpudsp's from the same state (>= 90 dB)."""
    n0 = 2 ** 32 - N // 2
    cj, ct = _cfgs("fm")
    tp, ts = tbank.build(ct, device="cpu")
    dtheta = tp.dtheta.numpy().astype(np.uint32)
    m = np.arange(N // 10, dtype=np.uint32)
    th_u = (np.uint32(n0) * dtheta)[:, None] + m[None, :] * (dtheta * np.uint32(10))[:, None]
    want = th_u.astype(np.float32) * np.float32(2 * np.pi / 4294967296.0)
    got = tbank.phase_lattice(ts.phase, torch.tensor(n0), tp.dtheta, 10, N // 10)
    np.testing.assert_array_equal(got.numpy(), want)
    x = (_fm_stream(N, seed=4) * 0.6).astype(np.complex64)
    jp, js = jbank.build(cj)
    js = js._replace(n0=np.uint32(n0))
    ts = ts._replace(n0=torch.tensor(n0))
    js, (yj, _) = jbank.bank_step(jp, js, x, cfg=cj)
    ts, (yt, _) = tbank.bank_step(tp, ts, torch.from_numpy(x), cfg=ct)
    assert min(_snrs(np.asarray(yj), yt.numpy())) >= 90.0
    assert int(ts.n0) == int(np.asarray(js.n0)) == N // 2


def test_mul_u32_is_the_uint32_product():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    b = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    got = tbank.mul_u32(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), (a * b) & np.uint64(0xFFFFFFFF))


def test_bank_rules():
    ct = _cfgs("fm")[1]
    with pytest.raises(ValueError):
        tbank.ReceiverBank(ct, block_len=N + 1, device="cpu")
    with pytest.raises(ValueError):
        tbank.ReceiverBank(ct, block_len=N, backend="tpu", device="cpu")
    with pytest.raises(ValueError):
        tbank.build(ct, "f32", device="cpu")
    rx = tbank.ReceiverBank(ct, block_len=N, input_format="u8", device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        rx(np.zeros(N, np.complex64))
    assert tbank.ReceiverBank(ct, block_len=N, backend="pallas", device="cpu").backend == "kernel"
