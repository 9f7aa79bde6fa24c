"""The port's receiver on raw wire input: i16 and u8 against its own c64
chain over two 500k-sample blocks (>= 90 dB, the JAX package's bar for
its raw paths), with the same carried state semantics."""

import numpy as np
import pytest
import torch

from tests.util import snr_db
from tpudsp_torch.chains import am as tam

N = 1_000_000
BLOCK = N // 2
SETTLE = N * 48 // 2_000 // 2


def _wire():
    rng = np.random.default_rng(7)
    t = np.arange(N)
    msg = np.sin(2 * np.pi * 1000.0 / 2e6 * t)
    x = ((1.0 + 0.5 * msg) * 0.3 * np.exp(2j * np.pi * 200.0 / 2e6 * t)
         + 0.01 * (rng.standard_normal(N) + 1j * rng.standard_normal(N)))
    i16 = np.stack([np.round(x.real * 32767), np.round(x.imag * 32767)],
                   -1).astype(np.int16)
    u8 = np.stack([np.round(x.real * 127.5 + 127.5),
                   np.round(x.imag * 127.5 + 127.5)], -1).astype(np.uint8)
    return {"c64": (i16[:, 0] + 1j * i16[:, 1]).astype(np.complex64) / 32767,
            "i16": i16, "u8": u8,
            "c64_from_u8": ((u8[:, 0] - 127.5) + 1j * (u8[:, 1] - 127.5)).astype(
                np.complex64) / np.float32(127.5)}


def _run(fmt, x):
    rx = tam.AMReceiver(tam.AMConfig(), BLOCK,
                        "c64" if fmt.startswith("c64") else fmt, device="cpu")
    return torch.cat([rx(torch.from_numpy(x[:BLOCK])),
                      rx(torch.from_numpy(x[BLOCK:]))]).numpy()


@pytest.fixture(scope="module")
def wire():
    return _wire()


@pytest.mark.parametrize("fmt,ref", [("i16", "c64"), ("u8", "c64_from_u8")])
def test_raw_formats_match_c64(wire, fmt, ref):
    y = _run(fmt, wire[fmt])
    y_ref = _run(ref, wire[ref])
    assert np.all(np.isfinite(y)) and y.shape == y_ref.shape
    s = snr_db(y_ref[SETTLE:], y[SETTLE:])
    assert s > 90.0, f"{fmt}: {s:.1f} dB"


@pytest.mark.parametrize("fmt,dtype", [("i16", np.uint8), ("u8", np.int16),
                                       ("c64", None)])
def test_wrong_wire_type_raises(fmt, dtype):
    rx = tam.AMReceiver(tam.AMConfig(), 50_000, fmt, device="cpu")
    bad = (np.zeros((50_000, 2), dtype) if dtype is not None
           else np.zeros((50_000, 2), np.complex64))
    with pytest.raises(TypeError):
        rx(bad)
