"""The port's checkpoint / resume (tpudsp_torch.io.checkpoint) and profiling
helpers (tpudsp_torch.utils) on the CPU: mirrors of tests/test_checkpoint.py
(an op and a chain saved mid-stream and restored into a fresh instance
continue bit for bit; a mismatched snapshot is rejected; stage_report),
annotate / trace, and the migration path: a tpudsp receiver's snapshot,
read back by tpudsp's load_state and carried over by convert.from_jax,
continues on the port >= 80 dB from tpudsp's next block (the bar of
tests/test_torch_chain.py against the Pallas back end)."""

import io
import json
import os

import numpy as np
import pytest
import torch

from tests.util import noise, snr_db
from tpudsp.chains import am as jam
from tpudsp.io import checkpoint as jckpt
from tpudsp_torch import compat as tdsp
from tpudsp_torch import convert
from tpudsp_torch.chains import AMConfig, AMReceiver
from tpudsp_torch.io.checkpoint import load_state, save_state
from tpudsp_torch.utils import annotate, stage_report, trace


def test_op_state_roundtrip(tmp_path):
    f = tdsp.ComplexIIRFilter(filter_type="cheby2", order=8, Fc=0.0075, device="cpu")
    x = noise(3000, complex_out=True, seed=1).astype(np.complex64)
    f(x)
    p = os.path.join(tmp_path, "iir.npz")
    save_state(p, f.state)
    y_cont = f(x)
    g = tdsp.ComplexIIRFilter(filter_type="cheby2", order=8, Fc=0.0075, device="cpu")
    g.with_state(load_state(p, g.state))
    np.testing.assert_array_equal(y_cont, g(x))


@pytest.mark.parametrize("make", [
    lambda: tdsp.ComplexResampler(rate=48_000 / 2_000_000, Fc=0.024, device="cpu"),
    lambda: tdsp.NCO(device="cpu"),
], ids=["resampler", "nco"])
def test_op_state_with_host_scalars_roundtrip(tmp_path, make):
    """Op states holding Python floats (a resampler's tau) and numpy
    scalars (the NCO's uint32 phase) come back as what the op's own state
    holds, and the op continues bit for bit."""
    x = noise(5001, complex_out=True, seed=2).astype(np.complex64)
    f, g = make(), make()
    step = (lambda o, v: o.mix_up(v)) if isinstance(f, tdsp.NCO) else (lambda o, v: o(v))
    if isinstance(f, tdsp.NCO):
        f.freq = 0.123
        f.adjust_phase(1.0)
    step(f, x)
    p = os.path.join(tmp_path, "op.npz")
    save_state(p, f.state)
    back = load_state(p, g.state)
    for k, v in g.state.items():
        assert type(back[k]) is type(v) or isinstance(v, np.generic), k
    g.with_state(back)
    np.testing.assert_array_equal(step(f, x), step(g, x))


def _am_iq(n, seed=0):
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    x = ((1 + 0.5 * np.sin(2 * np.pi * 1e-3 * t)) * 0.3 * np.exp(2j * np.pi * 1e-4 * t)
         + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return x.astype(np.complex64)


@pytest.mark.parametrize("kw", [dict(plan="fused", exact=True), dict()],
                         ids=["exact", "kernel"])
def test_chain_state_roundtrip(tmp_path, kw):
    n = 25_000
    iq = torch.from_numpy(_am_iq(n))
    rx = AMReceiver(AMConfig(), block_len=n, device="cpu", **kw)
    rx(iq)
    p = os.path.join(tmp_path, "chain.npz")
    save_state(p, rx.state)
    y_cont = rx(iq)
    rx2 = AMReceiver(AMConfig(), block_len=n, device="cpu", **kw)
    rx2.state = load_state(p, rx2.state)
    assert all(torch.is_tensor(v) for v in _tensor_leaves(rx2.state))
    torch.testing.assert_close(rx2(iq), y_cont, rtol=0, atol=0)


def _tensor_leaves(tree):
    out = []
    for v in tree:
        if isinstance(v, tuple):
            out += _tensor_leaves(v)
        elif v is not None:
            out.append(v)
    return out


def test_stereo_chain_int64_phase_roundtrip(tmp_path):
    """The stereo pilot's 32-bit phase (an int64 tensor masked to 32 bits
    in the port) round-trips as int64, and the chain continues bit for
    bit."""
    from tpudsp_torch.chains.wbfm import WBFMStereoReceiver
    n = 40_000
    t = np.arange(2 * n)
    comp = (np.sin(2 * np.pi * 700.0 / 2.4e6 * t)
            + 0.1 * np.cos(2 * np.pi * 19_000.0 / 2.4e6 * t)) * 0.008
    x = np.exp(1j * 2 * np.pi * np.cumsum(comp) * 4.0).astype(np.complex64)
    rx = WBFMStereoReceiver(block_len=n, device="cpu")
    rx(torch.from_numpy(x[:n]))
    p = os.path.join(tmp_path, "stereo.npz")
    save_state(p, rx.state)
    rx2 = WBFMStereoReceiver(block_len=n, device="cpu")
    rx2.state = load_state(p, rx2.state)
    phases = [v for v in _tensor_leaves(rx2.state) if v.dtype == torch.int64]
    assert phases, "no int64 leaf in the stereo state"
    assert int(rx2.state.pilot.phase_u) == int(rx.state.pilot.phase_u) >= 0
    torch.testing.assert_close(rx2(torch.from_numpy(x[n:])), rx(torch.from_numpy(x[n:])),
                               rtol=0, atol=0)


def test_stage_report(capsys):
    buf = io.StringIO()
    rec = stage_report("agc", out=np.ones(64, np.complex64),
                       modes=np.array([7] * 60 + [2] * 4),
                       extra={"gain": 1.5}, file=buf)
    assert rec["out_rms"] == 1.0
    assert rec["squelch_modes"] == {7: 60, 2: 4}
    assert "agc" in buf.getvalue()


def test_stage_report_takes_tensors_as_tpudsp_takes_arrays():
    from tpudsp.utils import stage_report as jreport
    rng = np.random.default_rng(3)
    out = (rng.standard_normal((3, 500)) + 1j * rng.standard_normal((3, 500))).astype(np.complex64)
    modes = rng.integers(0, 8, 500).astype(np.int32)
    ours = stage_report("bank", out=torch.from_numpy(out), modes=torch.from_numpy(modes),
                        file=io.StringIO())
    theirs = jreport("bank", out=out, modes=modes, file=io.StringIO())
    assert ours == theirs


def test_load_state_rejects_mismatched_snapshot(tmp_path):
    """A stale / mismatched snapshot must raise, not silently mis-assign
    compatible-shaped leaves."""
    from tpudsp_torch.kernels import agc as kagc
    from tpudsp_torch.kernels import pll as kpll
    p = os.path.join(tmp_path, "st.npz")
    save_state(p, kagc.agc_init(device="cpu"))
    # different structure entirely
    with pytest.raises(ValueError, match="different state structure"):
        load_state(p, kpll.pll_init(device="cpu"))
    # same structure, wrong leaf shapes
    wide = kagc.AgcState(*(v.expand(4) for v in kagc.agc_init(device="cpu")))
    with pytest.raises(ValueError, match="shape"):
        load_state(p, wide)
    # the happy path still round-trips
    st = load_state(p, kagc.agc_init(device="cpu"))
    assert float(st.g) == float(kagc.agc_init(device="cpu").g)


def test_none_is_a_node_without_a_leaf(tmp_path):
    """None (an absent part of a state, e.g. the coherent AM front of an
    FM bank) is recorded as such: it round-trips, and a snapshot with None
    where ``like`` holds a tensor is another structure."""
    p = os.path.join(tmp_path, "none.npz")
    state = {"front": None, "dc": torch.zeros(3), "tail": (torch.ones(2), None)}
    save_state(p, state)
    back = load_state(p, state)
    assert back["front"] is None and back["tail"][1] is None
    assert torch.equal(back["dc"], state["dc"])
    assert list(back) == list(state)
    with pytest.raises(ValueError, match="different state structure"):
        load_state(p, {**state, "front": torch.zeros(1)})


def test_annotate_and_trace_on_the_cpu(tmp_path):
    """annotate is a named span that shows in a trace, as a range of its own
    around its work, and leaves nothing outside one; trace writes a Chrome
    trace into its directory."""
    with annotate("outside.stage"):
        torch.ones(8).sum()
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        with annotate("chain.stage"):
            torch.ones(1000).cumsum(0)
    files = list(logdir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("chain.stage") == 1 and "outside.stage" not in names
    span = next(e for e in events if e.get("name") == "chain.stage")
    op = next(e for e in events if e.get("name") == "aten::cumsum")
    assert span["ts"] <= op["ts"] and op["ts"] + op["dur"] <= span["ts"] + span["dur"]


def test_migration_from_a_tpudsp_snapshot(tmp_path):
    """A stream moves from tpudsp to the port at a checkpoint: tpudsp's
    snapshot, read back by tpudsp's load_state and carried over by
    convert.from_jax, continues on the port >= 80 dB from tpudsp's next
    block."""
    n = 100_000
    iq = _am_iq(3 * n, seed=5)
    jrx = jam.AMReceiver(jam.AMConfig(), block_len=n, backend="pallas")
    jrx(iq[:n])
    jrx(iq[n:2 * n])
    p = os.path.join(tmp_path, "jax.npz")
    jckpt.save_state(p, jrx.state)
    want = np.asarray(jrx(iq[2 * n:]))

    fresh = jam.AMReceiver(jam.AMConfig(), block_len=n, backend="pallas")
    jstate = jckpt.load_state(p, fresh.state)
    rx = AMReceiver(AMConfig(), block_len=n, device="cpu")
    _, rx.state = convert.from_jax(fresh.params, jstate, device="cpu")
    got = rx(torch.from_numpy(iq[2 * n:])).numpy()
    assert got.shape == want.shape
    s = snr_db(want, got)
    assert s > 80.0, f"{s:.1f} dB"
