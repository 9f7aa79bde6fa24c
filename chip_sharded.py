#!/usr/bin/env python3
"""Drive the port's time-sharded AM receiver on a ring of ranks, one card
each, over NCCL.

    python3 chip_sharded.py

Run from the root of a checkout, on a machine with one or more cards.
One rank per card, each a process of its own (torch.multiprocessing,
spawn), sets its card, joins the default process group over
tcp://localhost and builds the (1, T) mesh with
``tpudsp_torch.parallel.make_mesh``. Every rank makes the same three
blocks of one AM stream from a seed (AMConfig(), the BASELINE config-1
chain; 4,000,000 samples per rank, so a block is T x 4M samples), puts
them on its card and feeds each whole block to ``ShardedAMReceiver``, as
a user would. The rings of 2 and 4 ranks on the CPU (gloo) are
tests/test_torch_sharded_am*.py.

Checks, each of which fails the run (exit code 1):
- halo='async' and halo='ppermute' over the three blocks with carried
  state: every rank returns the same pcm; async against ppermute
  >= 100 dB; each against the single-card AMReceiver on rank 0 (same
  blocks, same block length) >= 100 dB past the first block; all finite;
- every rank launched the halo_async kernel in the async run;
- every rank launched first_order_scan twice a block in each run (the DC
  tracker's rows and the de-emphasis).

Then times one block per mode (chip_smoke's ``_block_times``: median of
5 calls after a warm-up call, with spread; the slowest rank's) and the
single-card AMReceiver on the same block length, and prints the card's
name and power limit first and one JSON summary line last. The signal,
SNR and timing helpers are chip_smoke.py's.
"""

from __future__ import annotations

import datetime
import json
import socket
import subprocess
import sys

import numpy as np

from chip_smoke import BLOCK_4M, ROOT, _block_times, am_signal, log, snr_db


def rank_main(rank: int, T: int, port: int):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.cuda import first_order, halo_async
    from tpudsp_torch.parallel import ShardedAMReceiver, make_mesh
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=T,
                            timeout=datetime.timedelta(seconds=120))
    try:
        cfg = AMConfig()
        block = BLOCK_4M * T     # 4M samples per rank
        n_out = int(round(block * cfg.rate))
        iq = am_signal(3 * block, cfg.iq_rate, 200.0, noise=0.01, seed=0)
        blocks = [torch.from_numpy(iq[k * block:(k + 1) * block]).cuda() for k in range(3)]
        mesh = make_mesh(1, T)
        rxs = {h: ShardedAMReceiver(cfg, mesh, block, halo=h) for h in ("async", "ppermute")}
        pcm, launches, tails = {}, {}, {}
        for h, rx in rxs.items():
            torch.cuda.synchronize()
            halo_async._launch.launches = first_order._launch.launches = 0   # the run starts
            y = torch.cat([rx(b) for b in blocks])
            torch.cuda.synchronize()
            launches[h] = halo_async._launch.launches  # ... and ends
            tails[h] = first_order._launch.launches
            same = y.clone()
            dist.broadcast(same, src=0)
            ok = torch.tensor([int(torch.equal(same, y))], device="cuda")
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            pcm[h] = (y.cpu().numpy(), bool(ok))
        n_launch = torch.tensor([launches["async"]], device="cuda")
        dist.all_reduce(n_launch, op=dist.ReduceOp.MIN)
        tail = torch.tensor(list(tails.values()) * 2, device="cuda")
        dist.all_reduce(tail[:2], op=dist.ReduceOp.MIN)
        dist.all_reduce(tail[2:], op=dist.ReduceOp.MAX)

        times = {}
        for h, rx in rxs.items():       # every rank times its calls; the slowest's
            t = torch.tensor(_block_times(rx, blocks * 2), dtype=torch.float64, device="cuda")
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            times[h] = t.tolist()
        summary = None
        if rank == 0:
            ref = AMReceiver(cfg, block)
            y_ref = torch.cat([ref(b) for b in blocks]).cpu().numpy()
            times["AMReceiver on one card"] = _block_times(ref, blocks * 2)
            settle = n_out        # past the first block (PLL lock, DC settling)
            (ya, same_a), (yp, same_p) = pcm["async"], pcm["ppermute"]
            snr = {"async vs ppermute": snr_db(yp, ya),
                   "async vs AMReceiver": snr_db(y_ref[settle:], ya[settle:]),
                   "ppermute vs AMReceiver": snr_db(y_ref[settle:], yp[settle:])}
            finite = all(v.shape == (3 * n_out,) and np.all(np.isfinite(v))
                         for v in (ya, yp))
            log(f"sharded x{T}: {block} samples a block, "
                + ", ".join(f"{k} {v:.2f} dB" for k, v in snr.items())
                + f" (bar 100); every rank the same pcm: async {same_a}, "
                f"ppermute {same_p}; all finite {finite}; halo_async launches "
                f"on each rank >= {int(n_launch)}; first_order_scan launches per rank "
                f"(async, ppermute) from {tail[:2].tolist()} to {tail[2:].tolist()} "
                f"(expected {2 * len(blocks)})")
            rates = {}
            for name, (med, spread) in times.items():
                rates[name] = block / med
                log(f"timing: {name}, {block}-sample block: median {med * 1e3:.3f} ms "
                    f"of 5 (spread {spread * 100:.1f}%), {block / med / 1e6:.1f} Msamp/s")
            ok = (finite and same_a and same_p and min(snr.values()) >= 100.0
                  and int(n_launch) > 0 and set(tail.tolist()) == {2 * len(blocks)})
            summary = {"ok": ok, "ranks": T, "block": block, "snr_db": snr,
                       "samples_per_s": rates}
            log(json.dumps(summary))
        flag = torch.tensor([int(summary["ok"]) if summary else 1], device="cuda")
        dist.broadcast(flag, src=0)
        if not int(flag):
            raise SystemExit("chip_sharded.py: a check failed")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    if not (ROOT / "tpudsp_torch" / "parallel").is_dir():
        print("chip_sharded.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("chip_sharded.py: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    T = torch.cuda.device_count()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {T} ranks, one per card")
    try:
        mp.spawn(rank_main, args=(T, _free_port()), nprocs=T, join=True)
    except Exception as e:   # a rank failed: spawn has stopped the others
        print(f"chip_sharded.py: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
