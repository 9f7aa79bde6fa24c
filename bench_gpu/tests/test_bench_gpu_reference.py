"""The float64 reference: its frozen design copies against their float64
definitions, its fast forms against their sample-serial definitions, and
the whole of it against the port's entries on the CPU (the port's plain
versions) at a tiny size, across block boundaries."""

from __future__ import annotations

import math

import numpy as np
import pytest
import scipy.signal as sig
import torch

from bench_gpu import registry, signals
from bench_gpu.reference import am_chain, bank, designs
from bench_gpu.reference.precision import CONTROLS, F64, FP16, TF32, round_bits


def test_kaiser_lowpass_is_its_definition():
    n, fc, As = 31, 0.1, 60.0
    beta = 0.1102 * (As - 8.7)
    assert designs.kaiser_beta(As) == pytest.approx(beta)
    t = np.arange(n) - (n - 1) / 2
    want = 2 * fc * np.sinc(2 * fc * t) * np.kaiser(n, beta)
    np.testing.assert_allclose(designs.kaiser_lowpass(n, fc, As), want, rtol=0, atol=1e-15)


def test_resamp_bank_rows_are_the_prototype_on_its_lattice():
    m, fc, As, npfb = 3, 0.2, 60.0, 8
    H = designs.resamp_bank(m, fc, As, npfb)
    L = 2 * m * npfb + 1
    h = designs.kaiser_lowpass(L, fc / npfb, As)
    h = h / h.sum() * npfb
    for b in range(npfb + 1):
        for i in range(2 * m):
            k = b + (2 * m - i) * npfb
            assert H[b, i] == pytest.approx(h[k] if k < L else 0.0, abs=1e-15)


def test_cheby2_and_deemphasis_designs():
    sos = designs.iirdes_sos("cheby2", "lowpass", 8, 15000 / 2e6, As=60.0, Ap=0.5)
    w, H = sig.sosfreqz(sos, worN=[0.0, 2 * np.pi * 0.02], fs=2 * np.pi)
    assert abs(H[0]) == pytest.approx(1.0, abs=1e-9)          # unity at DC
    assert 20 * np.log10(abs(H[1])) <= -60.0 + 1e-6           # stopband
    b0, a = designs.deemphasis_coeffs(48000.0)
    assert a == pytest.approx(math.exp(-1.0 / (75e-6 * 48000.0))) and b0 == pytest.approx(1 - a)


def test_precision_rounds_as_the_card_does():
    x = np.random.default_rng(1).standard_normal(10000)
    bf16 = torch.tensor(x, dtype=torch.float32).bfloat16().double().numpy()
    np.testing.assert_array_equal(round_bits(x, 7), bf16)
    half = torch.tensor(x, dtype=torch.float32).half().double().numpy()   # normal range
    np.testing.assert_array_equal(round_bits(x, 10), half)
    assert FP16.bits_el == 10 and FP16.bits_mm is None
    assert TF32.bits_mm == 10 and TF32.bits_el is None
    assert F64.exact and not any(c.exact for c in CONTROLS)
    assert np.array_equal(F64.mm(x), x)


def test_channelizer_is_its_definition():
    C, T = 8, 4
    h = designs.kaiser_lowpass(C * T, 0.55 / C, 60.0)
    h = h / h.sum()
    x = np.random.default_rng(2).standard_normal(C * 40) * (1 + 0.5j)
    Y = bank.channelize_f64(x, h, C)
    want = np.zeros_like(Y)
    for m in range(Y.shape[0]):
        for k in range(C * T):
            if m * C - k >= 0:
                want[m] += h[k] * x[m * C - k] * np.exp(2j * np.pi * np.arange(C) * k / C)
    np.testing.assert_allclose(Y, want, atol=1e-12)


def test_resampler_is_the_sample_serial_one():
    H = designs.resamp_bank(3, 0.45 * 3 / 125, 60.0, 8)
    x = np.random.default_rng(3).standard_normal(1000) + 0j
    y = am_chain.resample_f64(x, H, 3, 125)
    X = np.concatenate([np.zeros(6), x])
    for k in range(len(y)):
        p = k * 125 / 3
        q = int(np.floor(p + 1e-9))
        fb = (p - q) * 8
        b = int(np.floor(fb + 1e-9))
        w = fb - b
        taps = (1 - w) * H[b] + w * H[b + 1]
        assert y[k] == pytest.approx(np.dot(X[q:q + 6], taps), abs=1e-12)


@pytest.fixture
def cpu_default(monkeypatch):
    from tpudsp_torch.ops import base
    monkeypatch.setattr(base, "DEFAULT_DEVICE", "cpu")


def _per_block_db(got, ref, n):
    out = []
    for b in range(got.shape[-1] // n):
        s = slice(b * n, (b + 1) * n)
        e = np.sum((got[..., s] - ref[..., s]) ** 2, axis=-1) / np.sum(ref[..., s] ** 2, axis=-1)
        out.append(float(10 * np.log10(np.max(e))))
    return out


def test_am_chain_against_the_port_across_blocks(cpu_default):
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    cfg = registry.config("am-readme-2msps")
    mix = dict(registry.traffic("am_tones.c64.b4m"), block_len=62500, ring_blocks=2)
    ring = signals.make_ring(mix, 2**31 + 9, "cpu")
    rx = AMReceiver(AMConfig(**cfg["am"]), 62500, "c64", device="cpu")
    got = np.concatenate([rx(ring[g % 2]).numpy() for g in range(3)])
    x = np.concatenate([signals.to_complex(ring[g % 2]) for g in range(3)])
    ref = am_chain.am_chain_f64(x, cfg["am"])
    assert max(_per_block_db(got, ref, 1500)) < -100.0


@pytest.mark.parametrize("signal", ["fm", "am"])
def test_bank_against_the_port_across_blocks(cpu_default, signal):
    ent = registry.entry("channelized_bank")
    cfg = registry.config("chbank-1024-100msps")
    cfg["channelizer"].update(nchan=64, iq_rate=6.25e6)
    name = "fm_every_channel.i16.b16m" if signal == "fm" else "am_every_channel.i16.b16m"
    mix = dict(registry.traffic(name), block_len=64 * 2048, ring_blocks=2, channels=64,
               amplitude=0.01, iq_rate=6.25e6)
    ring = signals.make_ring(mix, 2**31 + 17, "cpu")
    prog = ent.build(cfg, {"judge_prefix_s": 0.0}, mix, torch.device("cpu"))
    got = np.concatenate([prog(ring[g % 2]).numpy() for g in range(3)], axis=1)
    x = np.concatenate([signals.to_complex(ring[g % 2]) for g in range(3)])
    ref = bank.bank_f64(x, ent.reference_config(cfg, mix))
    assert max(_per_block_db(got, ref, 2048)) < -90.0
