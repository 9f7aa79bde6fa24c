#!/usr/bin/env python3
"""Drive the port's sharded runtimes on a ring of ranks, one card each,
over NCCL.

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
single-card AMReceiver on the same block length.

The other runtimes on the same ring, each against its single-card chain
on rank 0 (every rank must return the same output), each timed beside
it:
- ShardedBank, bank16 (chip_smoke's BANK_FREQS, 8M samples per time rank
  and block, three blocks) on a (1, T) mesh and, with four cards, (2, 2):
  against ReceiverBank >= 120 dB; halo_async and first_order_scan once a
  block on every rank;
- ShardedChannelizer and ShardedChannelizedBank (config 4: 1024
  channels, blocks of 1024 x 16384 samples) with the transform split over
  the T ranks, the two transposes riding NCCL's all_to_all: Y of the
  carriers' channels against Channelizer >= 120 dB, the FM carriers'
  audio against ChannelizedBank >= 100 dB; pfb_branch once a block;
- ShardedScanner (config 5's core) on (1, T), FM: the carriers' audio
  against ChannelizedBank >= 100 dB;
- PipelinedAMReceiver over cards 0 and 1 (in the parent process, once
  the ranks have left), four 4M-sample blocks and the flush: bit for bit
  against AMReceiver(backend='xla').

Prints the card's name and power limit first and one JSON summary line
last. The signals, SNR and timing helpers are chip_smoke.py's.
"""

from __future__ import annotations

import datetime
import json
import socket
import subprocess
import sys

import numpy as np

from chip_smoke import (BANK_FREQS, BLOCK_4M, N_BANK, N_PFB, PFB_AM, PFB_FM, ROOT, _block_times,
                        _snr_dev, _split, am_signal, bank_signal, log, pfb_signal, snr_db,
                        wire_blocks)


def _same_everywhere(y) -> bool:
    """Whether every rank holds rank 0's y (one broadcast, one all_reduce)."""
    import torch
    import torch.distributed as dist
    same = y.clone()
    dist.broadcast(same, src=0)
    ok = torch.tensor([int(torch.equal(same, y))], device="cuda")
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok)


def _slowest(rx, blocks):
    """The slowest rank's (median, spread) of rx's block time."""
    import torch
    import torch.distributed as dist
    t = torch.tensor(_block_times(rx, blocks), dtype=torch.float64, device="cuda")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _counted(rx, blocks, counter):
    """rx over the blocks, with the launches of ``counter`` (a kernel
    wrapper) made on this rank meanwhile; the fewest of any rank."""
    import torch
    import torch.distributed as dist
    torch.cuda.synchronize()
    counter.launches = 0
    outs = [rx(b) for b in blocks]
    torch.cuda.synchronize()
    n = torch.tensor([counter.launches], device="cuda")
    dist.all_reduce(n, op=dist.ReduceOp.MIN)
    return outs, int(n)


def _bank_audio(rx, blocks, rows, frames: bool = False):
    """One receiver's output over the blocks in turn (its state carried):
    audio (C, N) concatenated in time and cut to ``rows`` (all when None),
    or with ``frames`` a channel matrix (M, C) cut to those columns."""
    import torch
    out = torch.cat([rx(b) for b in blocks], 0 if frames else 1)
    return out if rows is None else out.index_select(1 if frames else 0, rows)


def ring_runtimes(rank: int, T: int) -> dict:
    """ShardedBank, the split channelizer and its bank, and the scanner on
    this ring, each against its single-card chain on rank 0; returns
    {case: (ok, note)} on rank 0."""
    import torch
    from tpudsp_torch.chains import (BankConfig, ChannelizedBank, ChannelizedBankConfig,
                                     Channelizer, ReceiverBank)
    from tpudsp_torch.cuda import halo_async, pfb
    from tpudsp_torch.parallel import (ShardedBank, ShardedChannelizedBank, ShardedChannelizer,
                                       ShardedScanner, make_mesh)
    out = {}

    def check(name, ref_fn, y, bar, launches, want, times):
        same = _same_everywhere(y)
        if rank == 0:
            s = _snr_dev(ref_fn(), y)
            ok = same and s >= bar and launches == want
            note = (f"{s:.2f} dB (bar {bar:g}), every rank the same {same}, launches "
                    f"{launches} (expected {want}); block time " + ", ".join(
                        f"{k} {v[0] * 1e3:.3f} ms (spread {v[1] * 100:.1f}%)"
                        for k, v in times.items()))
            log(f"sharded x{T}: {name}: {note}")
            out[name] = (ok, note)

    cfg = BankConfig(freqs=BANK_FREQS)
    for shape in [(1, T)] + ([(2, 2)] if T == 4 else []):
        block = N_BANK * shape[1]
        blocks = _split(bank_signal(3 * block, ("fm",) * 16, seed=40).to(torch.complex64), block)
        sb = ShardedBank(cfg, make_mesh(*shape), block)
        ys, n = _counted(sb, blocks, halo_async._launch)
        times = {"ShardedBank": _slowest(sb, blocks * 2)}
        ref = ReceiverBank(cfg, block) if rank == 0 else None
        if rank == 0:
            times["ReceiverBank on one card"] = _block_times(ref, blocks * 2)
        check(f"ShardedBank bank16 {shape}", lambda: _bank_audio(ReceiverBank(cfg, block),
                                                                 blocks, None),
              torch.cat(ys, 1), 120.0, n, len(blocks), times)
    wire = _split(pfb_signal(3, seed=42).to(torch.complex64), N_PFB)
    ccfg = ChannelizedBankConfig()
    mesh = make_mesh(1, T)
    carriers = torch.tensor(PFB_FM + PFB_AM, device="cuda")
    fm = torch.tensor(PFB_FM, device="cuda")
    sc = ShardedChannelizer(ccfg.channelizer, mesh, N_PFB, axis_name="time")
    ys, n = _counted(sc, wire, pfb.branch_accumulate)
    check("ShardedChannelizer config 4",
          lambda: _bank_audio(Channelizer(ccfg.channelizer, N_PFB), wire, carriers, frames=True),
          torch.cat(ys, 0).index_select(1, carriers), 120.0, n, len(wire),
          {"ShardedChannelizer": _slowest(sc, wire * 2)})
    for name, rt in (("ShardedChannelizedBank config 4 FM",
                      ShardedChannelizedBank(ccfg, mesh, N_PFB, axis_name="time")),
                     ("ShardedScanner config 5 core FM", ShardedScanner(ccfg, mesh, N_PFB))):
        ys, n = _counted(rt, wire, pfb.branch_accumulate)
        times = {name: _slowest(rt, wire * 2)}
        if rank == 0:
            times["ChannelizedBank on one card"] = _block_times(ChannelizedBank(ccfg, N_PFB),
                                                                wire * 2)
        check(name, lambda: _bank_audio(ChannelizedBank(ccfg, N_PFB), wire, fm),
              torch.cat(ys, 1).index_select(0, fm), 100.0, n, len(wire), times)
    return out


def _two_card_times(rx, blocks):
    """chip_smoke's ``_block_times`` with both cards synchronised after each
    call (the pipeline's stage 1 runs on card 1)."""
    import statistics
    import time
    import torch
    sync = lambda: [torch.cuda.synchronize(d) for d in (0, 1)]
    rx(blocks[0])
    sync()
    times = []
    for b in blocks[1:]:
        t0 = time.perf_counter()
        rx(b)
        sync()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med


def pipeline_two_cards() -> tuple:
    """PipelinedAMReceiver over cards 0 and 1 against AMReceiver(backend=
    'xla') on card 0, bit for bit; (ok, note)."""
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.parallel import PipelinedAMReceiver
    blocks = [torch.from_numpy(b).cuda(0) for b in wire_blocks(4, BLOCK_4M, seed=44)["c64"]]
    pp = PipelinedAMReceiver(AMConfig(), BLOCK_4M, mesh=("cuda:0", "cuda:1"))
    outs = [pp(b) for b in blocks] + [pp.flush()]
    rx = AMReceiver(AMConfig(), BLOCK_4M, backend="xla", device="cuda:0")
    want = torch.cat([rx(b) for b in blocks])
    got = torch.cat([o.to("cuda:0") for o in outs[1:]])
    same = outs[0] is None and torch.equal(want, got)
    pp(blocks[0])
    t_pp = _two_card_times(pp, blocks + blocks[:2])
    t_rx = _block_times(rx, blocks + blocks[:2])
    note = (f"bit for bit {same}; block time {t_pp[0] * 1e3:.3f} ms (spread "
            f"{t_pp[1] * 100:.1f}%) beside AMReceiver(backend='xla') {t_rx[0] * 1e3:.3f} ms "
            f"(spread {t_rx[1] * 100:.1f}%)")
    log(f"sharded: PipelinedAMReceiver over cuda:0 and cuda:1, 4 x 4M-sample blocks and the "
        f"flush: {note}")
    return same, note


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
        others = ring_runtimes(rank, T)
        if rank == 0:
            summary["others"] = {k: v[1] for k, v in others.items()}
            summary["ok"] = summary["ok"] and all(v[0] for v in others.values())
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
        # the pipeline in this process once the ranks have left: a rank
        # waiting in a collective spins on its card, which stage 1 shares
        if T >= 2 and not pipeline_two_cards()[0]:
            raise RuntimeError("the pipeline over two cards is not bit for bit")
    except Exception as e:   # a rank failed: spawn has stopped the others
        print(f"chip_sharded.py: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
