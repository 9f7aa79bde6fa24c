"""The port's two-stage pipelined AM receiver (``parallel.
PipelinedAMReceiver`` with both stages on the CPU: the plain versions of
every kernel) against the JAX package's on its 2-device CPU stage mesh and
against the port's own AMReceiver; mirrors tests/test_pipeline.py. The
JAX pipeline's parameters and state are carried over with
``convert.pipeline_from_jax``.

The chain is the default one with a faster AGC loop (bandwidth 0.05),
which cuts the warmup of the plain scans from 3840 to 1280 pcm samples;
blocks of 125,000 samples (3000 pcm samples), three blocks and the flush.

Bars: c64 >= 100 dB and wire input >= 90 dB from tpudsp (the chain bar
and the wire bar, as tests/test_torch_sharded_am.py holds the sharded
receiver); bit for bit against the port's AMReceiver with the same
back end ('xla', the pipeline's default, as the JAX pipeline's), where
the JAX test pins 120 dB against its single-chip receiver; flush's reset
bit for bit, as the JAX test pins it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.util import snr_db
from tpudsp_torch import convert
from tpudsp_torch.chains.am import AMConfig, AMReceiver
from tpudsp_torch.parallel import PipelinedAMReceiver, make_stage_mesh

CFG = AMConfig(agc_bandwidth=0.05)
BLOCK = 125_000
N_BLOCKS = 3
STAGES = ("cpu", "cpu")


def am_iq(n, seed=0):
    t = np.arange(n)
    msg = np.sin(2 * np.pi * 1000.0 / CFG.iq_rate * t)
    rng = np.random.default_rng(seed)
    x = (1.0 + 0.5 * msg) * 0.3 * np.exp(2j * np.pi * 200.0 / CFG.iq_rate * t)
    return (x + 0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def wire(iq, fmt):
    if fmt == "i16":
        w = np.stack([np.round(iq.real * 32767 * 0.5),
                      np.round(iq.imag * 32767 * 0.5)], 1).astype(np.int16)
        return w, ((w[:, 0] + 1j * w[:, 1]) / 32767.0).astype(np.complex64)
    w = np.stack([np.round(iq.real * 127.5 * 0.9 + 127.5),
                  np.round(iq.imag * 127.5 * 0.9 + 127.5)], 1).clip(0, 255).astype(np.uint8)
    return w, ((w[:, 0] - 127.5) / 127.5 + 1j * (w[:, 1] - 127.5) / 127.5).astype(np.complex64)


def blocks_of(x):
    return [x[i * BLOCK:(i + 1) * BLOCK] for i in range(len(x) // BLOCK)]


def stream(pipe, blocks):
    """The pipeline over the blocks and the flush: the pcm (the fill call
    must return None)."""
    out = [pipe(torch.as_tensor(b)) for b in blocks]
    assert out[0] is None
    return np.concatenate([o.numpy() for o in out[1:]] + [pipe.flush().numpy()])


@pytest.fixture(scope="module", params=["c64", "i16", "u8"])
def runs(request):
    """(format, blocks, tpudsp's pcm, the port's from tpudsp's parameters
    and state)."""
    from tpudsp.chains.am import AMConfig as JAMConfig
    from tpudsp.parallel.pipeline import PipelinedAMReceiver as J, make_stage_mesh as jstages
    fmt = request.param
    x = am_iq(N_BLOCKS * BLOCK)
    blocks = blocks_of(x if fmt == "c64" else wire(x, fmt)[0])
    jp = J(JAMConfig(**dataclasses.asdict(CFG)), BLOCK, mesh=jstages(), input_format=fmt)
    params, state = convert.pipeline_from_jax(jp.params, jp.state, make_stage_mesh(STAGES))
    out = [jp(b) for b in blocks]
    y_jax = np.concatenate([np.asarray(o) for o in out[1:]] + [np.asarray(jp.flush())])
    pp = PipelinedAMReceiver(CFG, BLOCK, mesh=STAGES, input_format=fmt)
    pp.params, pp.state = params, state
    return fmt, blocks, y_jax, stream(pp, blocks)


def test_pipeline_matches_jax(runs):
    fmt, _, y_jax, y = runs
    assert y.shape == y_jax.shape == (N_BLOCKS * BLOCK * 48 // 2000,)
    s = snr_db(y_jax, y)
    print(f"pipeline {fmt}: {s:.2f} dB")
    assert s >= (100.0 if fmt == "c64" else 90.0)


def test_pipeline_bit_equal_to_am_receiver(runs):
    """The stages run the single-device receiver's launches on the same
    values: bit for bit against AMReceiver(backend='xla') over the same
    blocks, the last one drained by the flush."""
    fmt, blocks, _, y = runs
    rx = AMReceiver(CFG, BLOCK, input_format=fmt, backend="xla", device="cpu")
    want = np.concatenate([rx(torch.as_tensor(b)).numpy() for b in blocks])
    np.testing.assert_array_equal(y, want)


def test_pipeline_flush_resets_stream():
    """flush() ends the stream: a new stream through the same receiver
    equals a fresh receiver's, bit for bit."""
    x = am_iq(2 * BLOCK, seed=7)
    pipe = PipelinedAMReceiver(CFG, BLOCK, mesh=STAGES)
    pipe(x[:BLOCK])
    pipe.flush()
    got = stream(pipe, blocks_of(x))
    want = stream(PipelinedAMReceiver(CFG, BLOCK, mesh=STAGES), blocks_of(x))
    np.testing.assert_array_equal(got, want)


def test_fill_call_leaves_the_back_end_alone():
    """On the fill call the buffer holds no block: stage 1 must not run
    (silence would wind the AGC gain up), so its state stays the initial
    one; stage 0's tail moves on."""
    pipe = PipelinedAMReceiver(CFG, BLOCK, mesh=STAGES)
    agc0 = pipe.state.agc
    assert pipe(am_iq(BLOCK)) is None
    assert all(torch.equal(a, b) for a, b in zip(pipe.state.agc, agc0))
    assert bool(pipe.state.buf.abs().max() > 0) and pipe.flush() is not None
    assert pipe.flush() is None              # nothing in flight after a flush


def test_pipeline_rules():
    pipe = PipelinedAMReceiver(CFG, BLOCK, mesh=STAGES)
    with pytest.raises(ValueError, match="expected block"):
        pipe(np.zeros(1000, np.complex64))
    pw = PipelinedAMReceiver(CFG, BLOCK, mesh=STAGES, input_format="i16")
    with pytest.raises(TypeError, match="expects"):
        pw(np.zeros(BLOCK, np.complex64))
    with pytest.raises(ValueError, match="rational rate"):
        PipelinedAMReceiver(AMConfig(pcm_rate=48_000 * np.sqrt(2) / 1.4), BLOCK, mesh=STAGES)
    with pytest.raises(ValueError, match="exact=False"):
        PipelinedAMReceiver(CFG, BLOCK, mesh=STAGES, exact=True, backend="kernel")
    # the first two cards by default: this host has none
    with pytest.raises(ValueError, match="pipeline needs 2 devices"):
        make_stage_mesh()
    assert make_stage_mesh(["cuda:0", "cuda:0"]) == (torch.device("cuda:0"),) * 2
