"""The port's elastic recovery runner (``parallel.ElasticRunner`` over the
port's AMReceiver on the CPU) against the JAX package's over tpudsp's
AMReceiver on the same blocks, and its snapshot, resume and replay
contract; mirrors tests/test_elastic.py. The JAX receiver's parameters
and state are carried over with ``convert.from_jax``.

Bars: the resumed stream bit for bit equal to an uninterrupted one (the
JAX test's pin), after a rebuilt runner and after a step that raises; the
port's stream >= 100 dB from tpudsp's (the chain bar; the exact back end,
whose exact AGC and PLL scans run the plain versions here).
"""

import os

import numpy as np
import pytest
import torch

from tests.util import noise, snr_db
from tpudsp_torch import convert
from tpudsp_torch.chains.am import AMConfig, AMReceiver
from tpudsp_torch.parallel import ElasticRunner

N_BLK = 62_500        # 1500 pcm samples a block (the JAX test: 125,000)
N = 6
CRASH = 5


def blocks():
    return [noise(N_BLK, complex_out=True, seed=i).astype(np.complex64) for i in range(N)]


def make():
    return AMReceiver(AMConfig(), N_BLK, exact=True, device="cpu")


@pytest.fixture(scope="module")
def truth():
    rx = make()
    return [rx(torch.from_numpy(b)).numpy() for b in blocks()]


def test_elastic_resume_exact(tmp_path, truth):
    """The runner dropped at block 5 (as if its process died), rebuilt from
    the snapshot of block 4, the blocks since replayed: bit for bit."""
    path = os.path.join(tmp_path, "am")
    runner = ElasticRunner(make, path, snapshot_every=2)
    out = []
    for i, b in enumerate(blocks()):
        if i == CRASH:
            del runner
            runner = ElasticRunner(make, path, snapshot_every=2)
            i0 = runner.block_index
            assert i0 == 4  # snapshots at blocks 2 and 4
            out = out[:i0]
            for j in range(i0, i):
                out.append(runner(torch.from_numpy(blocks()[j])).numpy())
        out.append(runner(torch.from_numpy(b)).numpy())
    for t, o in zip(truth, out):
        np.testing.assert_array_equal(t, o)
    assert not os.path.exists(path + ".tmp.npz")   # moved into place


class _FailsOnce:
    """A chain that raises at one block, once: a lost card or transport."""
    calls = 0

    def __init__(self, fail_at):
        self.rx = make()
        self.fail_at = fail_at

    @property
    def state(self):
        return self.rx.state

    @state.setter
    def state(self, s):
        self.rx.state = s

    def __call__(self, block):
        _FailsOnce.calls += 1
        if _FailsOnce.calls == self.fail_at:
            raise RuntimeError("the card went away")
        return self.rx(block)


def test_elastic_failed_step_restores_and_replays(tmp_path, truth):
    """A step that raises: the runner rebuilds the chain, restores the
    newest snapshot, re-raises the original error and reports where to
    replay from; the replayed stream is bit for bit the uninterrupted
    one."""
    _FailsOnce.calls = 0
    runner = ElasticRunner(lambda: _FailsOnce(fail_at=4), os.path.join(tmp_path, "am"),
                           snapshot_every=2)
    data, out, i = blocks(), [], 0
    while i < N:
        try:
            out.append(runner(torch.from_numpy(data[i])).numpy())
            i += 1
        except RuntimeError as e:
            assert "went away" in str(e)
            assert runner.block_index == 2
            out, i = out[:2], 2
    for t, o in zip(truth, out):
        np.testing.assert_array_equal(t, o)


def test_elastic_runner_matches_jax(tmp_path, truth):
    """The same stream through tpudsp's ElasticRunner over its exact
    AMReceiver: the port's (carried from tpudsp's design) >= 100 dB."""
    from tpudsp.chains import AMConfig as JAMConfig, AMReceiver as JAMReceiver
    from tpudsp.parallel.elastic import ElasticRunner as JElastic
    jr = JElastic(lambda: JAMReceiver(JAMConfig(), block_len=N_BLK, plan="fused", exact=True),
                  os.path.join(tmp_path, "jax"), snapshot_every=2)
    y_jax = np.concatenate([np.asarray(jr(b)) for b in blocks()])

    def carried():
        rx = make()
        jrx = JAMReceiver(JAMConfig(), block_len=N_BLK, plan="fused", exact=True)
        params, rx.state = convert.from_jax(jrx.params, jrx.state, device="cpu")
        for name, t in zip(params._fields, params):
            if name != "agc":
                setattr(rx, name, t)
        return rx
    runner = ElasticRunner(carried, os.path.join(tmp_path, "port"), snapshot_every=2)
    y = np.concatenate([runner(torch.from_numpy(b)).numpy() for b in blocks()])
    s = snr_db(y_jax, y)
    print(f"elastic vs tpudsp: {s:.2f} dB")
    assert s >= 100.0
    np.testing.assert_array_equal(y, np.concatenate(truth))


def test_resume_rejects_another_chain(tmp_path):
    """A snapshot of another chain's state is refused, not mis-assigned."""
    from tpudsp_torch.chains.bank import BankConfig, ReceiverBank
    path = os.path.join(tmp_path, "x")
    runner = ElasticRunner(make, path, snapshot_every=1)
    runner(torch.from_numpy(blocks()[0]))
    with pytest.raises(ValueError, match="different state structure"):
        ElasticRunner(lambda: ReceiverBank(BankConfig(freqs=(0.0,)), 5000, device="cpu"), path)
