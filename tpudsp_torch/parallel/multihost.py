"""Process-group set-up and the wideband scanner, BASELINE config 5 (port
of ``tpudsp/parallel/multihost.py``).

The transport is ``torch.distributed``: ``init_distributed`` joins the
default process group (NCCL between cards, gloo between CPU processes),
after which every mesh of ``mesh.make_mesh`` spans its ranks, on one host
or several. Nothing else in the runtime counts hosts: the same
ShardedBank / ShardedChannelizer / ShardedScanner code runs on one host or
on N.

The scanner (config 5: 1 Gsps synthetic IQ over N >= 2 hosts): the PFB
channelizer split in time with overlap-save boundary exchange (each time
rank needs the (T-1) C + C-1 samples before its slice, one halo exchange)
and the per-channel demod bank behind it: the FM discriminator's 1-sample
halo, coherent AM's warmup halo and the de-emphasis across time ranks
(``bank._first_order_time_sharded_blocked``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..chains import channelizer as cch
from ..chains.am import check_format, check_input
from ..chains.bank import _fm_base, _index_tensor
from ..chains.channelizer import ChannelizedBankConfig, ChannelizerState, DemodBankState
from ..utils.profiling import annotate
from .bank import (_first_order_time_sharded_blocked, all_gather, broadcast_from_last,
                   coherent_am_time_sharded)
from .halo import left_halo, left_halo_rows
from .mesh import TIME_AXIS, axis_size


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend: str = "nccl", timeout_s: float = 300.0) -> bool:
    """Join the default process group. With no arguments it reads the
    rendezvous ``torchrun`` sets (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE); ``coordinator_address`` ("host:port") with
    ``num_processes`` and ``process_id`` names one. The backend is NCCL,
    one card a process (the local rank's), unless the caller asks for
    gloo and CPU processes.

    Returns False when no rendezvous is configured (a single process: the
    runtime then uses one-rank meshes), True once the group is up (also
    when it already was). A configured rendezvous that fails raises:
    where JAX's ``initialize`` wrapper returns False on every exception,
    the port lets a rank that cannot join fail the run."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        return False
    kw = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    if backend == "nccl":
        # one card a process, the local rank's (torchrun sets LOCAL_RANK)
        local = int(os.environ.get("LOCAL_RANK", kw.get("rank", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def _channelize_local(Ht, tail_local, x_local, os: int = 1):
    """This rank's PFB given the exchanged tail: the single-card
    channelizer's step (``chains/channelizer._channelize``: one pfb_branch
    launch, the IFFT and, at os=2, the odd frames' sign, whose local
    frame parity is global parity because every time rank owns an even
    frame count). Raw wire slices frame at wire width. Returns (the tail
    after the slice, Y (M_loc, C))."""
    st, Y = cch._channelize(Ht, ChannelizerState(tail=tail_local), x_local, os, "shift")
    return st.tail, Y


def scanner_step(params, state: DemodBankState, x_local, mesh, *,
                 cfg: ChannelizedBankConfig):
    """One block on this time rank: channelize (the left neighbour's
    (T-1) C + C-1 boundary samples by one exchange; time rank 0 takes the
    block-carried tail), then demodulate every channel of the local frames
    (the FM discriminator's 1-sample halo, coherent AM's warmup halo, the
    de-emphasis across time ranks). params: (Ht, b0, a, amb, fm_mask) as
    ``chains/channelizer.bank_build`` makes them. Returns (this rank's
    state after the block, its audio (C, M_loc))."""
    plan = cfg.plan
    Ht, _, _, amb, fm_mask = params
    halo = left_halo_rows(x_local, state.ch.tail.shape[0], mesh, state.ch.tail)
    new_tail, Y = _channelize_local(Ht, halo, x_local, os=cfg.channelizer.oversample)
    Yc = Y.T.contiguous()                                   # (C, M_loc)
    front, dc = state.front, state.dc

    def fm_base():
        prev = left_halo(Yc, 1, mesh, state.fd_prev[:, None])
        return _fm_base(Yc, prev[:, 0], cfg.kd)

    def coherent(y):
        return coherent_am_time_sharded(amb, state.front, state.dc, y, plan.warmup, mesh)

    if plan.route == "fm":
        base = fm_base()
    elif plan.route == "cam":
        front, dc, base = coherent(Yc)
    elif plan.route == "am":
        base = torch.abs(Yc)
    else:
        # mixed: the channels are local to every time rank, so the coherent
        # back end takes its AM rows alone
        base = torch.where(fm_mask[:, None], fm_base(), torch.abs(Yc))
        if plan.coherent:
            idx = _index_tensor(plan.am_idx, Yc.device)
            front, dc, coh = coherent(Yc.index_select(0, idx))
            base = base.index_copy(0, idx, coh)
    deemph, audio = _first_order_time_sharded_blocked(*plan.deemph, state.deemph, base, mesh)
    new_state = DemodBankState(ch=ChannelizerState(tail=new_tail), fd_prev=Yc[:, -1].clone(),
                               deemph=deemph, front=front, dc=dc)
    return new_state, audio


class ShardedScanner:
    """The wideband scanner: the PFB channelizer and its demod bank, split
    in time over the mesh's time axis, one rank per process (the channel
    axis, if larger than 1, holds copies). Every rank is given the whole
    block, takes its time slice and returns the whole (C, M) audio (one
    all_gather); each keeps the last time rank's carries (one broadcast a
    block) as the next block's left fill. On one host the mesh is
    ``make_mesh(1, T)``; on several, the same after ``init_distributed``.
    The design and the carried state live on ``device``, the card unless
    the caller asks for the CPU. ``convert.scanner_from_jax`` carries a
    JAX scanner's parameters and state over."""

    def __init__(self, cfg: ChannelizedBankConfig, mesh, block_len: int,
                 input_format: str = "c64", *, device="cuda"):
        if cfg.channelizer.engine != "shift":
            raise NotImplementedError(
                "the sharded channelizer front end implements the 'shift' "
                f"PFB accumulation only; engine={cfg.channelizer.engine!r} "
                "would be silently mis-measured (use chains.channelizer "
                "for the conv engine, or engine='shift' here)")
        check_format(input_format)
        C = cfg.channelizer.nchan
        n_time = axis_size(mesh, TIME_AXIS)
        if block_len % (C * n_time):
            raise ValueError(f"block_len must be a multiple of {C * n_time}")
        os_ = cfg.channelizer.oversample
        if (os_ * (block_len // n_time) // C) % os_:
            # the odd frames' sign takes local frame parity for global parity
            raise ValueError("every time rank must own an even frame count at os=2")
        self.cfg = cfg
        self.mesh = mesh
        self.block_len = int(block_len)
        self.input_format = input_format
        self.n_loc = self.block_len // n_time
        self.params, self.state = cch.bank_build(cfg, input_format, device=device)

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def __call__(self, iq):
        iq = torch.as_tensor(iq)
        if iq.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} samples")
        t = self.mesh.get_local_rank(TIME_AXIS)
        x = check_input(iq[t * self.n_loc:(t + 1) * self.n_loc], self.input_format,
                        self.device)
        with annotate("ShardedScanner.step"):
            state, audio = scanner_step(self.params, self.state, x, self.mesh, cfg=self.cfg)
            self.state = broadcast_from_last(state, self.mesh)
            audio = all_gather(audio, self.mesh)              # (T, C, M_loc)
        return audio.permute(1, 0, 2).reshape(audio.shape[1], -1)
