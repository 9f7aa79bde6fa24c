"""The one traffic generator: a ring of distinct IQ blocks, made on the
device from ``--seed`` as a traffic mix file (``traffic/<mix>.json``)
describes it.

The ring is one periodic stream of ``ring_blocks`` x ``block_len``
samples: every channel c of ``channels`` (centred at c iq_rate / channels,
so a one-channel mix sits at 0 Hz) carries one signal whose spectral
lines lie on the grid iq_rate / (ring length), so the stream runs on from
the ring's last block into its first without a jump. The lines are set
by one inverse FFT of their sparse spectrum, and white complex noise is
added, so the whole ring costs a few large device calls:

- ``"signal": "am"``: a carrier of ``amplitude`` at a seeded offset,
  modulated to ``modulation`` by ``tones`` seeded audio tones (weights
  summing to one, so the envelope stays positive);
- ``"signal": "fm"``: a carrier of ``amplitude`` at a seeded offset,
  frequency-modulated by one seeded tone with a seeded deviation, as its
  Bessel lines J_p(beta), |p| <= ``bessel_lines``.

``noise_dbc`` is the noise power over the whole band against one
carrier's power. ``format`` "c64" gives (R, N) complex64 blocks, "i16"
the (R, N, 2) int16 wire (full scale 32767, clipped). Every seed draws the
same sizes, line counts and levels; only the offsets, tones, phases and
noise differ, so the device work is the same from seed to seed.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.special as sp
import torch


def rng_seed(seed: int) -> int:
    """The seed as a non-negative 63-bit integer."""
    return int(seed) % (1 << 63)


def _uniform(rng, span, n):
    lo, hi = span
    return rng.uniform(lo, hi, n)


def lines(mix: dict, seed: int):
    """(bins int64, values complex128) of the ring's spectral lines: the
    host-side draw from the seed."""
    rng = np.random.default_rng(rng_seed(seed))
    C = int(mix["channels"])
    L = int(mix["block_len"]) * int(mix["ring_blocks"])
    df = mix["iq_rate"] / L
    amp = float(mix["amplitude"])
    centre = np.arange(C, dtype=np.int64) * (L // C)
    off = np.round(_uniform(rng, mix["carrier_offset_hz"], C) / df).astype(np.int64)
    phase = rng.uniform(0.0, 2 * np.pi, C)
    bins, vals = [], []
    if mix["signal"] == "am":
        T = int(mix["tones"])
        f = np.round(_uniform(rng, mix["tone_hz"], (C, T)) / df).astype(np.int64)
        w = rng.uniform(0.5, 1.0, (C, T))
        w /= w.sum(axis=1, keepdims=True)
        th = rng.uniform(0.0, 2 * np.pi, (C, T))
        carrier = centre + off
        bins.append(carrier)
        vals.append(amp * np.exp(1j * phase))
        side = 0.5 * amp * mix["modulation"] * w
        for sgn in (1, -1):
            bins.append((carrier[:, None] + sgn * f).ravel())
            vals.append((side * np.exp(1j * (phase[:, None] + sgn * th))).ravel())
    elif mix["signal"] == "fm":
        P = int(mix["bessel_lines"])
        fm = np.round(_uniform(rng, mix["tone_hz"], C) / df).astype(np.int64)
        beta = _uniform(rng, mix["deviation_hz"], C) / (fm * df)
        th = rng.uniform(0.0, 2 * np.pi, C)
        p = np.arange(-P, P + 1)
        bins.append((centre + off)[:, None] + p[None, :] * fm[:, None])
        vals.append(amp * sp.jv(p[None, :], beta[:, None])
                    * np.exp(1j * (phase[:, None] + p[None, :] * th[:, None])))
    else:
        raise ValueError(f"unknown signal {mix['signal']!r} (use 'am' or 'fm')")
    return (np.concatenate([b.ravel() for b in bins]) % L,
            np.concatenate([v.ravel() for v in vals]))


def make_ring(mix: dict, seed: int, device):
    """The ring on ``device``: (R, N) complex64 or (R, N, 2) int16."""
    R, N = int(mix["ring_blocks"]), int(mix["block_len"])
    L = R * N
    bins, vals = lines(mix, seed)
    spec = torch.zeros(L, dtype=torch.complex64, device=device)
    spec.index_put_((torch.as_tensor(bins, device=device),),
                    torch.as_tensor(vals.astype(np.complex64), device=device),
                    accumulate=True)
    x = torch.view_as_real(torch.fft.ifft(spec, norm="forward"))   # (L, 2) f32
    del spec
    gen = torch.Generator(device=device)
    gen.manual_seed(rng_seed(seed))
    sigma = float(mix["amplitude"]) * math.sqrt(10.0 ** (mix["noise_dbc"] / 10.0) / 2.0)
    x.add_(torch.randn(x.shape, generator=gen, device=device), alpha=sigma)
    if mix["format"] == "c64":
        return torch.view_as_complex(x).reshape(R, N)
    if mix["format"] == "i16":
        return x.mul_(32767.0).round_().clamp_(-32767, 32767).to(torch.int16).reshape(R, N, 2)
    raise ValueError(f"unknown format {mix['format']!r} (use 'c64' or 'i16')")


def to_complex(block) -> np.ndarray:
    """A ring block (a host or device tensor) as the complex128 samples
    the program reads: i16 wire values over 32767."""
    b = block.cpu().numpy()
    if b.dtype == np.complex64:
        return b.astype(np.complex128)
    return (b[..., 0].astype(np.float64) + 1j * b[..., 1]) / 32767.0


def segment(ring, g0: int, n_prefix: int) -> np.ndarray:
    """The stream the program was given from n_prefix samples before block
    g0 (the stream's block g is ring slot g mod R) to the end of block
    g0 + 1, as complex128 on the host."""
    R, N = ring.shape[0], ring.shape[1]
    k = -(-n_prefix // N)
    x = np.concatenate([to_complex(ring[(g0 - k + i) % R]) for i in range(k + 2)])
    return x[k * N - n_prefix:]
