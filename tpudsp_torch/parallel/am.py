"""Time-sharded single-channel AM receiver (port of
``tpudsp/parallel/am.py``: BASELINE.json config 1 over the mesh's time
axis).

One long IQ block is split across the time ranks; each computes its slice
of the 48 kHz pcm, and the chain's three stream couplings become three
cheap exchanges:

1. fused front end (bandpass folded into the rational polyphase
   decimator, kernels/decimate.py): a kf-sample INPUT halo from the left
   neighbour. The local input length is a multiple of Q, so every rank's
   output grid has the same phase pattern. With ``halo='async'`` the
   offset-folded taps make the P resampler phases P channels of the
   async-halo front end (``cuda/halo_async.bank_front_async``: the
   exchange in flight while the kernel computes the interior outputs);
   with ``halo='ppermute'`` the halo is exchanged first
   (``halo.left_halo``), then the shared-grid matmul runs.
2. AGC + carrier-PLL feedback: each rank but 0 re-derives its loop entry
   state from a warmup-sized baseband halo (``bank.coherent_am_time_sharded``).
3. DC tracker and de-emphasis: first-order linear recurrences, exact
   across ranks through the gathered transition-aggregate prefix.

The receiver takes the full block on every rank, as the JAX receiver
takes a global array, and returns the full pcm on every rank (one
all_gather). The next block's carried state is the last rank's, broadcast
once per block. A 1x1 mesh (``mesh.LocalMesh``) runs the same code with
no collective. JAX's ``check_vma`` (shard_map's replication checking) has
no counterpart and is not an argument.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..chains.am import AMConfig, INPUT_FORMATS, _rational, build as am_build
from ..cuda import halo_async
from ..design import iirdes
from ..kernels import agc as kagc
from ..kernels import am_backend as kab
from ..kernels import ampmodem as kam
from ..kernels import decimate as kdec
from ..kernels import lanes
from ..kernels.warmup import warmup_for
from .bank import (_first_order_time_sharded_blocked, all_gather,
                   broadcast_from_last, coherent_am_time_sharded)
from .halo import left_halo, left_halo_rows
from .mesh import TIME_AXIS, axis_size

class SAMState(NamedTuple):
    rs_tail: torch.Tensor    # (kf,) carried fused-front input tail, or (kf, 2) wire
    front: kab.FrontState    # AGC + PLL feedback state (scalar leaves)
    dc: torch.Tensor         # f32 DC-tracker carry
    deemph: torch.Tensor     # f32 de-emphasis carry


def _sharded_am_step(taps, amb, state: SAMState, iq_loc, mesh, *, Q: int,
                     nj_loc: int, warmup: int, b0: float, a: float,
                     halo: str):
    """One block on this rank. iq_loc: (n_loc,) complex64 local slice, or
    (n_loc, 2) raw int16 / uint8 wire samples (taps carrying the wire
    scale; the halo then crosses at wire width). Returns (this rank's
    SAMState after the block, its pcm slice)."""
    kf = state.rs_tail.shape[0]
    if halo == "async":
        tre, tim = taps                  # (P, Kc2, Q) offset-folded, tim None or 0
        yp = halo_async.bank_front_async(iq_loc, state.rs_tail, tre, tim, Q,
                                         nj_loc, mesh)
        y48 = yp.T.reshape(-1)           # output k = j*P + r
        new_tail = torch.cat([state.rs_tail, iq_loc[-kf:]])[-kf:]
    elif iq_loc.ndim == 2:
        tail_loc = left_halo_rows(iq_loc, kf, mesh, state.rs_tail)
        if iq_loc.dtype == torch.uint8:
            t, dc = taps                 # u8 plan: (scaled taps, per-phase DC sums)
            new_tail, y48 = kdec.fused_frontend_apply_shared_u8(
                t, dc, tail_loc, iq_loc, Q, nj_loc)
        else:
            new_tail, y48 = kdec.fused_frontend_apply_shared_i16(
                taps, tail_loc, iq_loc, Q, nj_loc)
    else:
        tail_loc = left_halo(iq_loc, kf, mesh, state.rs_tail)
        new_tail, y48 = kdec.fused_frontend_apply_shared(
            taps, tail_loc, iq_loc, Q, nj_loc)

    # feedback back end across time ranks (a one-stream batch)
    front, dc, audio = coherent_am_time_sharded(
        amb, lanes.one_stream(state.front), state.dc.reshape(1), y48[None],
        warmup, mesh)
    deemph, pcm = _first_order_time_sharded_blocked(
        b0, a, state.deemph.reshape(1), audio, mesh)
    new_state = SAMState(rs_tail=new_tail, front=lanes.first_stream(front),
                         dc=dc[0], deemph=deemph[0])
    return new_state, pcm[0]


class ShardedAMReceiver(nn.Module):
    """The BASELINE config-1 AM receiver time-sharded over a mesh.

    cfg matches chains/am.AMConfig (the reference README chain); block_len
    must be a multiple of T * Q (Q = the rational rate's denominator, 125
    for 2 Msps -> 48 kHz) so each rank owns an integral output range, and
    each rank's audio slice must cover the loops' warmup window.
    ``halo`` is 'ppermute' (exchange, then filter) or 'async' (the
    async-halo kernel; complex64 input only); ``input_format`` 'c64',
    'i16' or 'u8'. The design and the carried ``state`` live on
    ``device``, the card unless the caller asks for the CPU; ``taps``
    holds the front end's taps in the JAX receiver's layout.
    ``convert.sharded_am_from_jax`` carries a JAX receiver's taps and
    state over."""

    def __init__(self, cfg: AMConfig = AMConfig(), mesh=None,
                 block_len: int = 1_000_000, halo: str = "ppermute",
                 input_format: str = "c64", *, device="cuda"):
        super().__init__()
        if mesh is None:
            raise ValueError("ShardedAMReceiver needs a mesh with a "
                             f"'{TIME_AXIS}' axis")
        if halo not in ("ppermute", "async"):
            raise ValueError(f"unknown halo {halo!r} "
                             "(use 'ppermute' or 'async')")
        if input_format not in INPUT_FORMATS:
            raise ValueError(f"unknown input_format {input_format!r} "
                             "(use 'c64', 'i16' or 'u8')")
        if input_format != "c64" and halo == "async":
            raise ValueError("halo='async' runs the complex64 ring kernel; "
                             "wire-format ingest uses halo='ppermute'")
        pq = _rational(cfg.rate)
        if pq is None:
            raise ValueError("time sharding needs a rational rate "
                             "(fused front end)")
        P, Q = pq
        T = axis_size(mesh, TIME_AXIS)
        if block_len % (T * Q):
            raise ValueError(f"block_len must be a multiple of T*Q = {T * Q}")
        self.cfg = cfg
        self.mesh = mesh
        self.block_len = int(block_len)
        self.input_format = input_format
        self.n_loc = self.block_len // T
        nj_loc = self.n_loc // Q
        self.warmup = warmup_for(agc_alpha=cfg.agc_bandwidth,
                                 pll_bw=kam.PLL_BW if cfg.carrier else None)
        if nj_loc * P < self.warmup:
            # the warmup halo comes from the immediate left neighbour only;
            # a shorter slice cannot re-derive its entry state
            raise ValueError(
                f"local audio slice ({nj_loc * P} samples) is shorter than "
                f"the loop warmup window ({self.warmup}); use block_len >= "
                f"{int(np.ceil(self.warmup / cfg.rate)) * T} or fewer time shards")

        params, st0, self.n_out = am_build(cfg, self.block_len, input_format,
                                           device=device)
        de_b0, de_a = iirdes.deemphasis_coeffs(cfg.pcm_rate)
        self._amb = kab.make_params(params.agc, cfg.modulation, de_b0, de_a,
                                    carrier=cfg.carrier)
        if halo == "async":
            # the offset-folded taps put the P phases on the kernel's
            # stride-Q window grid; they are real (Tim None: the kernel's
            # real-tap instance), where JAX passes zeros
            self.taps = (params.taps_fused, None)
        elif input_format == "u8":
            self.taps = (params.taps_fused, params.u8_dc)
        else:
            self.taps = params.taps_fused
        zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
        self.state = SAMState(
            rs_tail=st0.rs_tail,
            front=kab.FrontState(agc=kagc.agc_init(device=device),
                                 pll=kab.PllState(zero(), zero())),
            dc=zero(), deemph=zero())
        self._step_kw = dict(Q=Q, nj_loc=nj_loc, warmup=self.warmup,
                             b0=float(de_b0), a=float(de_a), halo=halo)

    @property
    def device(self) -> torch.device:
        return self.state.dc.device

    def forward(self, iq):
        iq = torch.as_tensor(iq)
        if self.input_format in ("i16", "u8"):
            want = torch.int16 if self.input_format == "i16" else torch.uint8
            if iq.dtype != want or iq.ndim != 2 or iq.shape[1] != 2:
                raise TypeError(
                    f"input_format={self.input_format!r} expects (N, 2) "
                    f"{want} [re, im]; got {iq.dtype} {tuple(iq.shape)}")
        elif iq.ndim != 1:
            raise TypeError(f"input_format='c64' expects (N,) complex; "
                            f"got shape {tuple(iq.shape)}")
        if iq.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} samples")
        r = self.mesh.get_local_rank(TIME_AXIS)
        iq_loc = iq[r * self.n_loc:(r + 1) * self.n_loc].to(self.device)
        if self.input_format == "c64":
            iq_loc = iq_loc.to(torch.complex64)
        state, pcm = _sharded_am_step(self.taps, self._amb, self.state,
                                      iq_loc.contiguous(), self.mesh,
                                      **self._step_kw)
        self.state = broadcast_from_last(state, self.mesh)
        return all_gather(pcm, self.mesh).reshape(-1)
