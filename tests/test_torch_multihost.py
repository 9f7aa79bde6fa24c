"""The port's process-group set-up (``parallel.init_distributed``) and the
scanner across processes that join by it; mirrors tests/test_multihost.py
(two local processes that initialise the distributed runtime against each
other and run the time-sharded scanner, config 5, across the process
boundary, against the single-device bank).

Where JAX's ``init_distributed`` returns False on any exception, the
port's returns False only when no rendezvous is configured and raises
when a configured one fails (ROADMAP.md Queue C pins the difference).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.torch_ranks import run_ranks
from tests.util import snr_db
from tpudsp_torch.chains.channelizer import (ChannelizedBank, ChannelizedBankConfig,
                                             ChannelizerConfig)
from tpudsp_torch.parallel import ShardedScanner, init_distributed, make_mesh

ROOT = Path(__file__).resolve().parent.parent
C = 32
N = C * 2048
CFG = ChannelizedBankConfig(channelizer=ChannelizerConfig(nchan=C, taps_per_branch=6,
                                                          iq_rate=3_200_000.0),
                            demod="fm", kd=0.25)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _iq():
    t = np.arange(2 * N)
    x = sum(np.exp(1j * (2 * np.pi * (c / C) * t + 2 * np.pi * 0.1 / C * np.cumsum(
        np.sin(2 * np.pi * 0.0004 * (i + 1) * t)))) for i, c in enumerate((3, 11, 25)))
    return (x / 3).astype(np.complex64)


def _scanner_rank(rank, world, tmp_path, port):
    """Join by init_distributed (gloo, tcp://127.0.0.1), then the scanner
    on a (1, world) mesh over two blocks, and an all_reduce."""
    assert init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=60)
    assert init_distributed() is True            # already up
    x = torch.tensor([rank + 1.0])
    dist.all_reduce(x)
    sc = ShardedScanner(CFG, make_mesh(1, world, "cpu"), N, device="cpu")
    iq = _iq()
    audio = torch.cat([sc(torch.from_numpy(iq[:N])), sc(torch.from_numpy(iq[N:]))], 1)
    np.save(tmp_path / f"audio_{rank}.npy", audio.numpy())
    np.save(tmp_path / f"sum_{rank}.npy", x.numpy())


def test_two_process_sharded_scanner(tmp_path):
    """Two processes join one group through init_distributed and run the
    scanner across the process boundary: every process the same audio,
    the occupied channels >= 100 dB from the single-device bank."""
    run_ranks(tmp_path, 2, _scanner_rank, tmp_path, _free_port(), group=False,
              timeout=180.0)
    ys = [np.load(tmp_path / f"audio_{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(ys[0], ys[1])
    assert [float(np.load(tmp_path / f"sum_{r}.npy")[0]) for r in range(2)] == [3.0, 3.0]
    iq = _iq()
    ref = ChannelizedBank(CFG, N, device="cpu")
    y_ref = np.concatenate([ref(torch.from_numpy(b)).numpy() for b in (iq[:N], iq[N:])], 1)
    for c in (3, 11, 25):
        assert snr_db(y_ref[c], ys[0][c]) >= 100.0


def test_no_rendezvous_is_a_single_process(monkeypatch):
    """No arguments and no launcher's environment: False, and no group."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not dist.is_initialized()


def test_torchrun_environment_joins():
    """The environment torchrun sets (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE): one process joins a group of one over gloo."""
    code = ("import torch.distributed as dist; from tpudsp_torch.parallel import "
            "init_distributed; print(init_distributed(backend='gloo'), dist.get_world_size(), "
            "dist.get_backend()); dist.destroy_process_group()")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
               WORLD_SIZE="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-800:]
    assert res.stdout.split() == ["True", "1", "gloo"]


def test_a_configured_rendezvous_that_fails_raises():
    """A rank that cannot reach its coordinator fails (JAX's wrapper would
    return False and run on alone)."""
    code = ("from tpudsp_torch.parallel import init_distributed; "
            f"init_distributed('127.0.0.1:{_free_port()}', 2, 1, backend='gloo', timeout_s=3)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    with pytest.raises(ValueError, match="num_processes and process_id"):
        init_distributed("127.0.0.1:1")
