"""Scaling-efficiency harness (port of ``tpudsp/bench_scaling.py``).

Measures every sharded flagship of ``tpudsp_torch.parallel`` at every
power-of-two rank count the process group allows, against its own
one-rank run:

    efficiency(N) = throughput(N) / (N * throughput(1))

Flagships (one row each per N):
  - bank:     the time-sharded 16-channel receiver bank (ShardedBank;
              halo 'ppermute', or --halo async for the ring kernel)
  - am:       the time-sharded single-channel AM receiver (config 1)
  - scanner:  the time-sharded channelize + demod (config 5's core)
  - tp:       the channelizer with its transform split across ranks
  - pipeline: the two-stage pipelined AM receiver beside the one-device
              AMReceiver (rank 0 alone, once the other ranks have left:
              the first two cards, or both stages on rank 0's card when
              it sees one)

Run one process a rank, as ``torchrun`` starts them:

    torchrun --nproc-per-node N -m tpudsp_torch.bench_scaling [nchan] \\
        [block_exp] [--halo async] [--only bank,am,scanner,tp,pipeline] \\
        [--json PATH] [--device cpu]

(or with no launcher: one rank). It runs on the card by default, one card
a rank over NCCL; ``--device cpu`` runs the ranks as CPU processes over
gloo. A block's time is the median of 5 calls after a warm-up call, each
ending synchronised, on the host clock with its spread and, on the card,
by CUDA events; a rank count's time is its slowest rank's. Every row names
its platform, and on the card the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them; a CPU row says it is one and is never a card figure. With ``--json``
rank 0 writes the rows to PATH, and nowhere else; PATH may not be the
JAX package's committed ``SCALING.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
ITERS = 5
FLAGSHIPS = ("bank", "am", "scanner", "tp", "pipeline")


def _noise(n, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.1).astype(np.complex64)


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def block_times(call, devices, iters: int = ITERS) -> dict:
    """``call()`` timed after a warm-up call: the host-clock median of
    ``iters`` calls (ms) with its spread (max - min over the median), each
    call ending with every one of ``devices`` synchronised, and on one card
    the CUDA-event median (ms; None across two cards, whose events do not
    compare)."""
    devices = [torch.device(d) for d in devices]
    timed = devices[0] if len(set(devices)) == 1 and devices[0].type == "cuda" else None
    call()
    _sync(devices)
    host, events = [], []
    for _ in range(iters):
        if timed is not None:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
        t0 = time.perf_counter()
        call()
        if timed is not None:
            e1.record()
        _sync(devices)
        host.append((time.perf_counter() - t0) * 1e3)
        if timed is not None:
            events.append(e0.elapsed_time(e1))
    med = statistics.median(host)
    return {"host_ms": med, "host_spread": (max(host) - min(host)) / med,
            "cuda_event_ms": statistics.median(events) if events else None}


def sub_mesh(n_chan: int, n_time: int, device):
    """A (channel, time) mesh over the first n_chan x n_time ranks of the
    default group (every rank must call it; ranks outside get None), or
    a LocalMesh for one rank."""
    from .parallel.mesh import CHANNEL_AXIS, TIME_AXIS, LocalMesh, make_mesh
    n = n_chan * n_time
    if n == 1:
        return LocalMesh(device.type)
    if n == dist.get_world_size():
        return make_mesh(n_chan, n_time, device)
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh(device.type, torch.arange(n).reshape(n_chan, n_time),
                      mesh_dim_names=(CHANNEL_AXIS, TIME_AXIS))
    return mesh if dist.get_rank() < n else None


def build_bank(mesh, block, device, nchan: int, halo: str):
    from .chains.bank import BankConfig
    from .parallel import ShardedBank
    cfg = BankConfig(freqs=tuple(float(f) for f in np.linspace(-1e6, 1e6, nchan, endpoint=False)))
    return ShardedBank(cfg, mesh, block, halo=halo, device=device)


def build_am(mesh, block, device):
    from .chains.am import AMConfig
    from .parallel import ShardedAMReceiver
    return ShardedAMReceiver(AMConfig(), mesh, block, device=device)


def build_scanner(mesh, block, device):
    from .chains.channelizer import ChannelizedBankConfig, ChannelizerConfig
    from .parallel import ShardedScanner
    cfg = ChannelizedBankConfig(channelizer=ChannelizerConfig(nchan=256, taps_per_branch=8))
    return ShardedScanner(cfg, mesh, block, device=device)


def build_tp(mesh, block, device):
    from .chains.channelizer import ChannelizerConfig
    from .parallel import ShardedChannelizer
    return ShardedChannelizer(ChannelizerConfig(nchan=1024, taps_per_branch=8), mesh, block,
                              device=device)


def _slowest(t: dict, device) -> dict:
    """Each time key's largest value over the ranks (one all_reduce; the
    ranks outside a sub-mesh give zeros)."""
    keys = ("host_ms", "host_spread", "cuda_event_ms")
    v = torch.tensor([t.get(k) or 0.0 for k in keys], dtype=torch.float64,
                     device=device if device.type == "cuda" else "cpu")
    if dist.is_initialized():
        dist.all_reduce(v, op=dist.ReduceOp.MAX)
    out = dict(zip(keys, v.tolist()))
    if device.type != "cuda" or t.get("cuda_event_ms", 0.0) is None:
        out["cuda_event_ms"] = None
    return out


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the cards, or None."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = sorted(set(smi.stdout.strip().splitlines()))
    return "; ".join(lines) or None


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Scaling efficiency of the sharded runtimes.")
    ap.add_argument("nchan", nargs="?", type=int, default=16, help="bank channels (16)")
    ap.add_argument("block_exp", nargs="?", type=int, default=20,
                    help="block of 2^block_exp samples (20)")
    ap.add_argument("--halo", choices=("ppermute", "async"), default="ppermute")
    ap.add_argument("--only", help="comma-separated flagships of " + ",".join(FLAGSHIPS))
    ap.add_argument("--json", type=Path, help="write the rows here (rank 0)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.json is not None and args.json.resolve() == (ROOT / "SCALING.json").resolve():
        ap.error("SCALING.json is the JAX package's record: name another path")
    return args


def main(argv=None) -> int:
    from .parallel import init_distributed
    args = parse(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_scaling: no CUDA device (use --device cpu for CPU ranks)")
    init_distributed(backend="nccl" if args.device == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
              else torch.device("cpu"))
    only = set(args.only.split(",")) if args.only else set(FLAGSHIPS)
    block0 = 1 << args.block_exp
    if device.type == "cuda":
        card = card_line()
        platform = {"platform": "gpu", "device_kind": torch.cuda.get_device_name(device),
                    "card": card, "caveat": "measured on the card"}
    else:
        platform = {"platform": "cpu", "device_kind": "cpu", "card": None,
                    "caveat": "CPU processes over gloo: the communication structure under "
                              "host scheduling, not a card figure"}
    rows = []

    def emit(row):
        if rank:
            return
        row = dict(row, n_ranks=world, **platform)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.json:
            tmp = args.json.with_name(args.json.name + ".tmp")
            tmp.write_text(json.dumps(rows, indent=1))
            os.replace(tmp, args.json)

    if rank == 0:
        print(f"bench_scaling: {world} rank(s) on {platform['device_kind']}"
              f" ({platform['card'] or platform['caveat']})", flush=True)

    timed = (("bank", lambda m, b: build_bank(m, b, device, args.nchan, args.halo), 50, 1),
             ("am", lambda m, b: build_am(m, b, device), 125, 1),
             ("scanner", lambda m, b: build_scanner(m, b, device), 256, 1),
             ("tp", lambda m, b: build_tp(m, b, device), 1024 * 8, 0))
    for name, build, quant, time_axis in timed:
        if name not in only:
            continue
        base, n = None, 1
        while n <= world:
            shape = (1, n) if time_axis else (n, 1)
            if name == "tp":
                block = 1024 * 8 * n * max(1, block0 // (1024 * 64))
            else:
                block = block0 - block0 % (quant * n)
            mesh = sub_mesh(*shape, device)
            t, skipped = {}, ""
            if mesh is not None:
                try:
                    rt = build(mesh, block)
                except (ValueError, NotImplementedError) as e:
                    skipped = str(e)
                else:
                    iq = torch.from_numpy(_noise(block, seed=len(name))).to(device)
                    t = block_times(lambda: rt(iq), [device])
            # every rank meets in the reduction, members or not
            t = _slowest(t, device)
            if skipped:
                emit({"flagship": name, "shards": n, "block": block, "skipped": skipped})
            else:
                sps = block / (t["host_ms"] / 1e3)
                base = sps if base is None else base
                emit({"flagship": name, "halo": args.halo if name == "bank" else None,
                      "axis": "time" if time_axis else "channel", "shards": n, "block": block,
                      "samples_per_s": sps, "efficiency_vs_1rank": sps / (n * base), **t})
            if dist.is_initialized():
                dist.barrier()
            n *= 2

    if dist.is_initialized():
        # the other ranks leave here: a rank waiting in a collective spins
        # on its card, and would share stage 1's card with the pipeline
        dist.barrier()
        dist.destroy_process_group()
    block = block0 - block0 % 125_000
    if "pipeline" in only and rank == 0 and block:
        from .chains.am import AMConfig, AMReceiver
        from .parallel import PipelinedAMReceiver, make_stage_mesh
        if device.type == "cuda":
            stages = make_stage_mesh() if torch.cuda.device_count() >= 2 else (device, device)
        else:
            stages = ("cpu", "cpu")
        iq = torch.from_numpy(_noise(block, seed=4)).to(device)
        rx = AMReceiver(AMConfig(), block, device=device)
        t1 = block_times(lambda: rx(iq), [device])
        pp = PipelinedAMReceiver(AMConfig(), block, mesh=stages)
        pp(iq)   # the fill call
        t2 = block_times(lambda: pp(iq), pp.mesh)
        emit({"flagship": "pipeline", "axis": "stage", "shards": 2,
              "stages": [str(d) for d in pp.mesh], "block": block,
              "samples_per_s": block / (t2["host_ms"] / 1e3),
              "single_device_samples_per_s": block / (t1["host_ms"] / 1e3),
              "ratio_vs_single": t1["host_ms"] / t2["host_ms"], **t2, "single_device": t1})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
