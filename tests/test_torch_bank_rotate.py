"""The receiver bank's fused rotation and FM discriminator
(``cuda/bank_rotate.fm_base``, csrc/bank_rotate.cu) and its plain version
(``kernels/bank_rotate.fm_base``).

On the CPU: the plain version bit for bit against the eager form it
replaces in ``chains/bank.bank_step`` (``phase_lattice``, the rotation by
``torch.polar``, ``_fm_base``) at C = 1, 16 and 17, lengths that are no
multiple of the kernel's 512-output chunk, n0 and phase across the 2^32
wrap, zero samples and a zero carry, three chained blocks; the FM bank's
steps bit for bit against the same bank with the eager form, in c64, i16
and u8; and only a bank whose every channel is FM taking the fused pass.

On the card (marker ``card``): the kernel bit for bit against its plain
version, run on the card with PyTorch's ops, at bank16's shape (16 x
800,000), at ragged and one-output shapes, across the wrap, with zero,
infinite and NaN samples and over three chained calls; one launch counted
a call; the receiver bank launching it once a block when every channel is
FM and never otherwise. Imports no jax. The card's machine has no jax,
which tests/conftest.py imports, so run it there without the conftest:

    python3 -m pytest --noconftest tests/test_torch_bank_rotate.py -m card
"""

import numpy as np
import pytest
import torch

from tpudsp_torch.chains import bank as tbank
from tpudsp_torch.cuda import bank_rotate
from tpudsp_torch.kernels import bank_rotate as kbr

FS = 2_400_000.0
N = 20_000                    # samples a bank block: 2000 at the channel rate
FREQS = (-500_000.0, -150_000.0, 200_000.0, 450_000.0)
KD = 18_750.0 / (FS / 10)
WRAP = 2 ** 32


def _eager(y1m, phase, n0, dtheta, D1, fd_prev, kd):
    """bank_step's eager form of the same step: the lattice, the rotation
    by torch.polar, then _fm_base; and the last rotated samples."""
    theta = tbank.phase_lattice(phase, n0, dtheta, D1, y1m.shape[1])
    y1 = y1m * torch.polar(torch.ones_like(theta), -theta)
    return tbank._fm_base(y1, fd_prev, kd), y1[:, -1].clone()


def _case(C, nj, seed, wrap=False, device="cpu"):
    """(y1m, phase, n0, dtheta, fd_prev): random samples and carries; with
    ``wrap`` n0 half the block short of 2^32 and phases just below it."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((C, nj)) + 1j * rng.standard_normal((C, nj))
    phase = WRAP - 1 - rng.integers(0, 1000, C) if wrap else rng.integers(0, WRAP, C)
    n0 = WRAP - 10 * nj // 2 if wrap else int(rng.integers(0, WRAP))
    fd = rng.standard_normal(C) + 1j * rng.standard_normal(C)
    t = lambda v, dt: torch.as_tensor(np.asarray(v), dtype=dt, device=device)
    return (t(y.astype(np.complex64), torch.complex64), t(phase, torch.int64),
            t(n0, torch.int64), t(rng.integers(0, WRAP, C), torch.int64),
            t(fd.astype(np.complex64), torch.complex64))


def _bits(t):
    """A float or complex tensor's words as int32; any other as it is."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def _same(a, b):
    return all(u.shape == v.shape and torch.equal(_bits(u), _bits(v)) for u, v in zip(a, b))


@pytest.mark.parametrize("C,nj,wrap", [(1, 777, False), (16, 1000, False), (17, 513, False),
                                       (16, 1000, True), (17, 1, True)])
def test_plain_version_is_the_eager_form(C, nj, wrap):
    y1m, phase, n0, dtheta, fd = _case(C, nj, seed=C * nj, wrap=wrap)
    if wrap:   # the lattice's sum passes 2^32 inside the block
        assert int(n0) + 10 * nj > WRAP
    got = kbr.fm_base(y1m, phase, n0, dtheta, 10, fd, KD)
    assert got[0].shape == (C, nj) and got[0].dtype == torch.float32
    assert got[1].shape == (C,) and got[1].dtype == torch.complex64
    assert _same(got, _eager(y1m, phase, n0, dtheta, 10, fd, KD))
    assert _same(bank_rotate.fm_base(y1m, phase, n0, dtheta, 10, fd, KD), got)


def test_zero_samples_and_a_zero_carry_give_zero():
    """patan2 is 0 where the conjugate product is (0, 0): zero samples,
    and a zero carry before output 0."""
    y1m, phase, n0, dtheta, fd = _case(4, 600, seed=3)
    y1m[0, 100:140] = 0.0
    y1m[1, 0] = 0.0
    y1m[2, 511:514] = 0.0
    fd[3] = 0.0
    got = kbr.fm_base(y1m, phase, n0, dtheta, 10, fd, KD)
    assert _same(got, _eager(y1m, phase, n0, dtheta, 10, fd, KD))
    base = got[0]
    assert bool((base[0, 100:141] == 0).all()) and bool((base[1, :2] == 0).all())
    assert bool((base[2, 511:515] == 0).all()) and float(base[3, 0]) == 0.0
    assert bool((base[:, 200:300] != 0).all())


def _non_finite(case):
    """Infinite and NaN samples in channels 3-5 of a (6, 2000) case, the
    last sample of channel 5 among them."""
    y1m = case[0]
    y1m[3, 40] = complex(float("inf"), 0.0)
    y1m[4, 1023] = complex(float("nan"), 0.5)
    y1m[5, 1999] = complex(0.25, float("-inf"))
    return case


def test_non_finite_samples():
    """An infinite or NaN product gives patan2's 0, so the rows stay
    finite; a non-finite last sample is carried as it is."""
    y1m, phase, n0, dtheta, fd = _non_finite(_case(6, 2000, seed=11))
    got = kbr.fm_base(y1m, phase, n0, dtheta, 10, fd, KD)
    assert _same(got, _eager(y1m, phase, n0, dtheta, 10, fd, KD))
    assert bool(torch.isfinite(got[0]).all()) and not bool(torch.isfinite(got[1][5]))
    assert float(got[0][4, 1023]) == float(got[0][4, 1024]) == 0.0


def test_three_chained_blocks_are_one_block():
    """The carry (the last rotated sample) and n0 advanced by the block's
    samples: three blocks give the bits of one block of their length, and
    each block the eager form's."""
    C, nj, D1 = 16, 1500, 10
    y1m, phase, n0, dtheta, fd = _case(C, 3 * nj, seed=5, wrap=True)
    whole = kbr.fm_base(y1m, phase, n0, dtheta, D1, fd, KD)
    rows, carry, n0k = [], fd, n0
    for k in range(3):
        block = y1m[:, k * nj:(k + 1) * nj].contiguous()
        base, last = kbr.fm_base(block, phase, n0k, dtheta, D1, carry, KD)
        assert _same((base, last), _eager(block, phase, n0k, dtheta, D1, carry, KD))
        rows.append(base)
        carry, n0k = last, (n0k + D1 * nj) & tbank.MASK
    assert int(n0) + 3 * D1 * nj > WRAP
    assert _same((torch.cat(rows, 1), carry), whole)


def _carriers(n, seed):
    """An FM carrier at each of FREQS, and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = sum(0.2 * np.exp(1j * (2 * np.pi * np.cumsum(
        fc / FS + 18_750.0 / FS * np.sin(2 * np.pi * (700.0 + 600.0 * k) / FS * t))
        + rng.uniform(0, 2 * np.pi))) for k, fc in enumerate(FREQS))
    return 0.6 * x + 0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))


def _wire(x, fmt):
    if fmt == "c64":
        return torch.from_numpy(x.astype(np.complex64))
    v = np.stack([x.real, x.imag], 1)
    if fmt == "i16":
        return torch.from_numpy(np.clip(np.round(v * 32767), -32767, 32767).astype(np.int16))
    return torch.from_numpy(np.clip(np.round(v * 127.5 + 127.5), 0, 255).astype(np.uint8))


@pytest.mark.parametrize("fmt", ["c64", "i16", "u8"])
def test_fm_bank_steps_are_the_eager_steps(fmt, monkeypatch):
    """An FM bank over three blocks from n0 just short of the wrap: audio
    and every carried state bit for bit those of the same bank with the
    eager form in the fused pass's place."""
    cfg = tbank.BankConfig(freqs=FREQS, iq_rate=FS, kd=KD)
    params, state0 = tbank.build(cfg, fmt, device="cpu")
    state0 = state0._replace(n0=torch.tensor(WRAP - N - N // 2))
    blocks = [_wire(b, fmt) for b in np.split(_carriers(3 * N, seed=7), 3)]

    def run():
        st, out = state0, []
        for b in blocks:
            st, (audio, _) = tbank.bank_step(params, st, b, cfg=cfg)
            out.append(audio)
        return torch.cat(out, 1), st

    fused = run()
    monkeypatch.setattr(tbank.bank_rotate, "fm_base", _eager)
    eager = run()
    assert _same((fused[0],), (eager[0],))
    assert int(fused[1].n0) == int(eager[1].n0) == N + N // 2
    for f in ("fd_prev", "a_tail", "deemph", "in_tail", "phase"):
        assert _same((getattr(fused[1], f),), (getattr(eager[1], f),)), f
    assert float(fused[0][:, 100:].abs().max()) > 0.1


@pytest.mark.parametrize("demod,calls", [
    ("fm", 2), ("am", 0), ("usb", 0), ("lsb", 0), (("fm", "am", "usb", "lsb"), 0),
    (("fm",) * 4, 2)])
def test_only_an_all_fm_bank_takes_the_fused_pass(demod, calls, monkeypatch):
    """bank_step calls cuda/bank_rotate.fm_base once a block where every
    channel is FM, whether the configuration says 'fm' or a tuple of it,
    and never otherwise; on CPU tensors it launches nothing."""
    seen = []
    fm_base = bank_rotate.fm_base
    monkeypatch.setattr(bank_rotate, "fm_base", lambda *a: seen.append(a) or fm_base(*a))
    launches = bank_rotate._launch.launches
    cfg = tbank.BankConfig(freqs=FREQS, iq_rate=FS, kd=KD, demod=demod)
    rx = tbank.ReceiverBank(cfg, block_len=N, device="cpu")
    for b in np.split(_carriers(2 * N, seed=8).astype(np.complex64), 2):
        assert rx(torch.from_numpy(b)).shape == (4, N // 50)
    assert len(seen) == calls and bank_rotate._launch.launches == launches


def test_launch_refuses_cpu_tensors():
    y1m, phase, n0, dtheta, fd = _case(2, 10, seed=1)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        bank_rotate._launch(y1m, phase, n0, dtheta, 10, fd, KD)


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _on_card(case, dev):
    y1m, phase, n0, dtheta, fd = case
    k0 = bank_rotate._launch.launches
    k = bank_rotate.fm_base(y1m, phase, n0, dtheta, 10, fd, KD)
    assert bank_rotate._launch.launches == k0 + 1
    r = kbr.fm_base(y1m, phase, n0, dtheta, 10, fd, KD)
    torch.cuda.synchronize(dev)
    return k, r


@pytest.mark.card
@pytest.mark.parametrize("C,nj,wrap", [(16, 800_000, False), (16, 800_000, True),
                                       (17, 777, False), (3, 1, True), (1, 512, False),
                                       (5, 513, True)])
def test_kernel_is_its_plain_version_on_the_card(C, nj, wrap):
    dev = _card()
    k, r = _on_card(_case(C, nj, seed=C + nj, wrap=wrap, device=dev), dev)
    assert [tuple(t.shape) for t in k] == [(C, nj), (C,)]
    assert _same(k, r)


@pytest.mark.card
def test_kernel_with_zero_and_non_finite_samples_on_the_card():
    dev = _card()
    y1m, phase, n0, dtheta, fd = _non_finite(_case(6, 2000, seed=11, device=dev))
    y1m[0, 100:140] = 0.0
    y1m[1, 511:514] = 0.0
    fd[2] = 0.0
    k, r = _on_card((y1m, phase, n0, dtheta, fd), dev)
    assert _same(k, r)
    assert bool(torch.isfinite(k[0]).all()) and not bool(torch.isfinite(k[1][5]))
    assert bool((k[0][0, 100:141] == 0).all()) and float(k[0][2, 0]) == 0.0


@pytest.mark.card
def test_kernel_chained_calls_on_the_card():
    dev = _card()
    y1m, phase, n0, dtheta, fd = _case(16, 3000, seed=12, wrap=True, device=dev)
    (kf, kl), (rf, rl), n0k = (fd, None), (fd, None), n0
    for lo, hi in ((0, 1000), (1000, 1001), (1001, 3000)):
        block = y1m[:, lo:hi].contiguous()
        k = bank_rotate.fm_base(block, phase, n0k, dtheta, 10, kf, KD)
        r = kbr.fm_base(block, phase, n0k, dtheta, 10, rf, KD)
        torch.cuda.synchronize(dev)
        assert _same(k, r)
        kf, rf, n0k = k[1], r[1], (n0k + 10 * (hi - lo)) & tbank.MASK


@pytest.mark.card
@pytest.mark.parametrize("demod,per_block", [("fm", 1), ("am", 0), (("fm", "am", "usb", "lsb"), 0)])
def test_bank_launches_it_once_a_block_when_all_fm_on_the_card(demod, per_block):
    dev = _card()
    cfg = tbank.BankConfig(freqs=FREQS, iq_rate=FS, kd=KD, demod=demod)
    rx = tbank.ReceiverBank(cfg, block_len=N, device=dev)
    k0 = bank_rotate._launch.launches
    for b in np.split(_carriers(3 * N, seed=9).astype(np.complex64), 3):
        rx(torch.from_numpy(b).to(dev))
    torch.cuda.synchronize(dev)
    assert bank_rotate._launch.launches - k0 == 3 * per_block
