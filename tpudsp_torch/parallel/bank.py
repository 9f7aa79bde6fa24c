"""The sharded receiver bank and the cross-shard helpers of the
time-sharded runtime (port of ``tpudsp/parallel/bank.py``).

- ``_first_order_time_sharded_blocked``: a first-order LINEAR recurrence
  (the coherent-AM DC tracker, de-emphasis) across time ranks. Each rank
  runs the blocked local scan from a zero entry and exposes its transition
  aggregate (a^n_loc, u_total); one all_gather of the T tiny aggregates
  and an exclusive double-float prefix give each rank its entry value,
  applied as y = y_zero + a^(k+1) entry.
- ``coherent_am_time_sharded``: the coherent AM back end (AGC + carrier
  PLL + DC tracker) across time ranks. The warmup-chunk scheme is the
  time-sharding scheme: each rank but 0 re-derives its loop entry state
  from the left neighbour's last ``warmup`` baseband samples (one halo
  exchange), then runs the chunked front locally.
- ``sharded_bank_step`` / ``ShardedBank``: ``chains/bank.py``'s step over
  a (channel, time) mesh. The channel axis slices the per-channel
  parameters and state (no communication); the time axis splits the
  shared IQ stream, with three boundary couplings as halo exchanges (the
  (K1-1)-sample channel-filter input halo, the 1-sample discriminator
  halo, the (K2-1)-sample audio-filter halo) and the de-emphasis and DC
  tracker across ranks through ``_first_order_time_sharded_blocked``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..chains import bank as cbank
from ..chains.am import INPUT_FORMATS
from ..chains.bank import BankConfig, BankParams, BankState
from ..cuda import am_backend_scan as scan
from ..cuda import first_order, halo_async
from ..design import iirdes
from ..kernels import iir as kiir
from ..kernels import lanes
from ..kernels.ampmodem import DC_RHO, PLL_BW
from ..kernels.warmup import chunk_for, warmup_for
from ..utils.profiling import annotate
from .halo import left_halo, left_halo_rows
from .mesh import CHANNEL_AXIS, TIME_AXIS, axis_size


def all_gather(x, mesh, axis: str = TIME_AXIS):
    """(T,) + x.shape: every time rank's x, in rank order (one collective;
    on a one-rank axis, x itself)."""
    T = axis_size(mesh, axis)
    if T == 1:
        return x[None]
    out = torch.empty(T * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1),
                                group=mesh.get_group(axis))
    return out.reshape((T,) + tuple(x.shape))


def broadcast_from_last(state, mesh, axis: str = TIME_AXIS):
    """The last rank's ``state`` (a tree of tensors, None leaves kept) on
    every rank of ``axis``: its leaves' bytes, packed into one tensor, in
    one broadcast."""
    T = axis_size(mesh, axis)
    if T == 1:
        return state
    leaves = []
    lanes.tree_map(leaves.append, state)
    packed = torch.cat([v.contiguous().reshape(-1).view(torch.uint8)
                        for v in leaves])
    group = mesh.get_group(axis)
    dist.broadcast(packed, src=dist.get_global_rank(group, T - 1), group=group)
    sizes = [v.numel() * v.element_size() for v in leaves]
    parts = iter(p.clone().view(v.dtype).reshape(v.shape)
                 for p, v in zip(packed.split(sizes), leaves))
    return lanes.tree_map(lambda _: next(parts), state)


@functools.lru_cache(maxsize=16)
def _powers(a: float, n: int, device: torch.device):
    """a^(k+1), k < n, rounded to f32 from float64 on the host."""
    k = np.arange(1, n + 1, dtype=np.float64)
    return torch.tensor(a ** k, dtype=torch.float32, device=device)


def _first_order_time_sharded_blocked(b0: float, a: float, y0, x_local, mesh):
    """Cross-rank first-order scan y[n] = b0 x[n] + a y[n-1] for
    near-unit poles:

      1. zero-entry blocked local scan of all C rows
         (cuda/first_order.first_order_apply_blocked: one launch of
         csrc/first_order_scan.cu on the card);
      2. the ranks' transition aggregates (a^n_loc from float64 host math,
         u_total = the zero-entry scan's last sample) combined in (hi, lo)
         double-float: one all_gather, then an exclusive prefix over the
         ranks before this one;
      3. y = y_zero + a^(k+1) * entry (exact first-order algebra).

    b0, a: Python floats; y0: (C,) f32 block-carried value; x_local: (C,
    n_loc) f32. Returns (y_last (C,), y (C, n_loc))."""
    b0 = float(b0)
    a = float(a)
    C, n_loc = x_local.shape
    zero = torch.zeros((C,), dtype=torch.float32, device=x_local.device)
    _, y_zero = first_order.first_order_apply_blocked(b0, a, zero, x_local)
    u_all = all_gather(y_zero[:, -1], mesh)                # (T, C)
    aS = tuple(torch.full((), v, dtype=torch.float32, device=x_local.device)
               for v in kiir._split64(np.float64(a) ** n_loc))
    pa = (torch.ones_like(y0), torch.zeros_like(y0))
    pu = (torch.zeros_like(y0), torch.zeros_like(y0))
    for t in range(mesh.get_local_rank(TIME_AXIS)):
        pa = kiir._df_mul(pa, aS)
        pu = kiir._df_add(kiir._df_mul(aS, pu), (u_all[t], torch.zeros_like(y0)))
    eh, el = kiir._df_add(kiir._df_mul(pa, (y0, torch.zeros_like(y0))), pu)
    entry = eh + el                                          # (C,)
    y_local = y_zero + _powers(a, n_loc, x_local.device)[None, :] * entry[:, None]
    return y_local[:, -1], y_local


def coherent_am_time_sharded(amb, front0, dc0, y1, warmup: int, mesh):
    """Coherent AM back end (AGC + carrier PLL + DC tracker) across time
    ranks. Rank 0 starts from the block-carried state ``front0``; every
    other rank re-derives its entry state by running the front exactly
    over its left neighbour's last ``warmup`` samples from ``front0``: one
    single-lane launch of the front-scan kernel on the card
    (``cuda/am_backend_scan.front_exact``), its plain loop on the CPU.
    Then the chunked front runs locally, and the DC tracker crosses ranks
    exactly through ``_first_order_time_sharded_blocked``.

    amb: kernels/am_backend.AmBackendParams; front0: FrontState of (C,)
    leaves; dc0: (C,); y1: (C, M_loc) complex64 local baseband; warmup:
    the loops' warmup window (kernels/warmup.warmup_for). Returns (front,
    dc, base)."""
    C, nj1 = y1.shape
    w = min(warmup, nj1)
    halo = left_halo(y1, w, mesh, torch.zeros((C, w), dtype=y1.dtype,
                                              device=y1.device))
    entry = front0
    if mesh.get_local_rank(TIME_AXIS) > 0:
        entry, _ = scan.front_exact(amb, front0, halo)
    front, (vr, _modes) = scan.front_chunked(amb, entry, y1,
                                             chunk_for(warmup), warmup)
    dc, dct = _first_order_time_sharded_blocked(1.0 - DC_RHO, DC_RHO, dc0,
                                                vr, mesh)
    return front, dc, (vr - dct) * amb.inv_mod


def _left_halo_1d(x_local, halo: int, mesh, fill):
    """``halo.left_halo`` on the mesh's time axis (time on the last axis)."""
    return left_halo(x_local, halo, mesh, fill)


def _coherent_warmup(cfg: BankConfig) -> int:
    return warmup_for(agc_alpha=cfg.agc_bandwidth, pll_bw=PLL_BW,
                      squelch_timeout=cfg.squelch_timeout if cfg.squelch else 0)


def sharded_bank_step(params: BankParams, state: BankState, iq, mesh, *,
                      cfg: BankConfig, halo: str = "ppermute",
                      coherent_mode: str | None = None, am_idx: tuple = ()):
    """One block on this rank. iq: this rank's (N_loc,) complex64 slice or
    raw (N_loc, 2) int16 / uint8 wire slice; params and state hold this
    rank's channel slice (``channel_slice``). Returns (this rank's
    BankState after the block, its audio (C_loc, N_loc / (D1 D2))).

    halo='ppermute' exchanges the (K1-1)-sample input halo first (at wire
    width for wire input), then runs the bank front on one card
    (``cuda/halo_async.cfir``, the halo read in place); halo='async'
    launches the front over the ring with the exchange in flight
    (``cuda/halo_async.bank_front_async``).

    coherent_mode routes cfg.am_coherent in a mixed bank: 'gather' (the
    channels are local to every rank) runs the coherent back end on the
    AM rows alone; 'all' (the channel axis is sharded, so the local AM
    rows are not known in advance) runs it on every local row and selects
    the AM rows by mask, with state.front and state.dc sized C."""
    D1, D2 = cfg.decim1, cfg.decim2
    K1, K2 = cfg.taps1, cfg.taps2
    n_loc = iq.shape[0]
    nj1 = n_loc // D1
    t_idx = mesh.get_local_rank(TIME_AXIS)
    if halo == "async":
        y1m = halo_async.bank_front_async(iq, state.in_tail, params.taps_re,
                                          params.taps_im, D1, nj1, mesh)
        halo_in = state.in_tail
    else:
        halo_in = left_halo_rows(iq, K1 - 1, mesh, state.in_tail)
        y1m = halo_async.cfir(iq, halo_in, params.taps_re, params.taps_im, D1, nj1)
    # the rotation at the GLOBAL output index: this rank's block starts
    # t_idx * n_loc samples after the block's, all mod 2^32
    n0 = (state.n0 + t_idx * n_loc) & cbank.MASK
    theta = cbank.phase_lattice(state.phase, n0, params.dtheta, D1, nj1)
    y1 = y1m * torch.polar(torch.ones_like(theta), -theta)

    def fm_base():
        prev = _left_halo_1d(y1, 1, mesh, state.fd_prev[:, None])
        return cbank._fm_base(y1, prev[:, 0], cfg.kd)

    demods = cbank._demod_tuple(cfg)
    ssb_any = any(d in ("usb", "lsb") for d in demods)
    all_ssb = all(d in ("usb", "lsb") for d in demods)
    front, dc = state.front, state.dc
    if cfg.demod == "fm":
        base = fm_base()
    elif cfg.demod == "am":
        if cfg.am_coherent:
            front, dc, base = coherent_am_time_sharded(
                params.amb, state.front, state.dc, y1, _coherent_warmup(cfg), mesh)
        else:
            base = torch.abs(y1)
    elif isinstance(cfg.demod, str) and ssb_any:
        # the real demod is the one-sided decimator below; this base only
        # keeps the a_tail carry
        base = y1.real
    else:   # mixed bank: every demod computed, selected per channel
        base = torch.where(params.fm_mask[:, None], fm_base(),
                           torch.where(params.ssb_mask[:, None], y1.real, torch.abs(y1)))
        if cfg.am_coherent and coherent_mode is not None:
            w = _coherent_warmup(cfg)
            if coherent_mode == "gather":
                idx = cbank._index_tensor(am_idx, y1.device)
                front, dc, coh = coherent_am_time_sharded(
                    params.amb, state.front, state.dc, y1.index_select(0, idx), w, mesh)
                base = base.index_copy(0, idx, coh)
            else:   # 'all': the coherent back end on every row, AM rows kept
                front, dc, coh = coherent_am_time_sharded(
                    params.amb, state.front, state.dc, y1, w, mesh)
                am_mask = ~(params.fm_mask | params.ssb_mask)
                base = torch.where(am_mask[:, None], coh, base)
    fd_prev = y1[:, -1].clone()

    nj2 = nj1 // D2
    A = torch.cat([_left_halo_1d(base, K2 - 1, mesh, state.a_tail), base], 1)
    audio = cbank._audio_decimate(A, params.h2, D2, nj2)

    y1_tail = state.y1_tail
    if ssb_any:
        K2s = cfg.taps2_ssb
        Yf = torch.cat([_left_halo_1d(y1, K2s - 1, mesh, state.y1_tail), y1], 1)
        yi = Yf.imag * params.lsb_sign[:, None]
        audio_ssb = (cbank._audio_decimate(Yf.real, params.h2s_re, D2, nj2)
                     - cbank._audio_decimate(yi, params.h2s_im, D2, nj2))
        audio = audio_ssb if all_ssb else torch.where(
            params.ssb_mask[:, None], audio_ssb, audio)
        y1_tail = Yf[:, -(K2s - 1):].clone()

    b0_de, a_de = iirdes.deemphasis_coeffs(cfg.audio_rate)
    deemph, audio = _first_order_time_sharded_blocked(b0_de, a_de, state.deemph, audio, mesh)

    new_state = BankState(
        in_tail=torch.cat([halo_in, iq[-(K1 - 1):]])[-(K1 - 1):],
        phase=state.phase,
        n0=(state.n0 + n_loc * axis_size(mesh, TIME_AXIS)) & cbank.MASK,
        fd_prev=fd_prev,
        a_tail=A[:, -(K2 - 1):].clone(),
        deemph=deemph,
        front=front, dc=dc,
        y1_tail=y1_tail,
    )
    return new_state, audio


_CHANNEL_PARAMS = ("taps_re", "taps_im", "dtheta", "fm_mask", "ssb_mask", "lsb_sign")
_CHANNEL_STATE = ("phase", "fd_prev", "a_tail", "deemph", "front", "dc", "y1_tail")


def channel_slice(params: BankParams, state: BankState, mesh):
    """A whole bank's params and state -> this rank's channel slice: the
    per-channel leaves (the taps, increments and masks; the phases and
    every per-channel carry, the coherent AM front and DC tracker
    included) cut along axis 0 by the rank's ``channel`` coordinate; the
    shared audio taps and the input tail as they are."""
    n_chan = axis_size(mesh, CHANNEL_AXIS)
    if n_chan == 1:
        return params, state
    C_loc = params.dtheta.shape[0] // n_chan
    c0 = mesh.get_local_rank(CHANNEL_AXIS) * C_loc
    cut = lambda v: v[c0:c0 + C_loc].contiguous()
    params = params._replace(**{f: lanes.tree_map(cut, getattr(params, f))
                                for f in _CHANNEL_PARAMS})
    state = state._replace(**{f: lanes.tree_map(cut, getattr(state, f))
                              for f in _CHANNEL_STATE})
    return params, state


class ShardedBank:
    """The receiver bank over a (channel, time) mesh, one rank per process.

    The channel axis slices the per-channel parameters and state; the IQ
    stream is split along the time axis. Every rank is given the whole
    block, as the JAX bank is given a global array, takes its time slice
    and returns the whole (C, N / (D1 D2)) audio (two all_gathers: time,
    then channel). Each rank keeps the last time rank's carries (one
    broadcast a block) as the next block's left fill, which time rank 0
    takes through the halo exchange's fill path, as JAX's wrapper keeps
    its last time shard's. A (1, 1) mesh (``mesh.LocalMesh``) runs the
    same code with no collective; its front end is the single-card bank's
    launch, its de-emphasis and DC tracker add their entry values after a
    zero-entry scan.

    ``halo`` is 'ppermute' or 'async' (``sharded_bank_step``); JAX's
    ``check_vma`` (shard_map's replication checking, which interpret mode
    needs off for the async kernel) has no counterpart and is not an
    argument. ``input_format`` 'c64', 'i16' or 'u8'. The design and the
    carried state live on ``device``, the card unless the caller asks for
    the CPU. ``convert.sharded_bank_from_jax`` carries a JAX bank's
    parameters and state over."""

    def __init__(self, cfg: BankConfig, mesh, block_len: int, halo: str = "ppermute",
                 input_format: str = "c64", *, device="cuda"):
        if halo not in ("ppermute", "async"):
            raise ValueError(f"unknown halo {halo!r} (use 'ppermute' or 'async')")
        if input_format not in INPUT_FORMATS:
            raise ValueError(f"unknown input_format {input_format!r} "
                             "(use 'c64', 'i16' or 'u8')")
        D = cfg.decim1 * cfg.decim2
        n_time = axis_size(mesh, TIME_AXIS)
        n_chan = axis_size(mesh, CHANNEL_AXIS)
        if cfg.nchan % n_chan:
            raise ValueError("channel count must divide over the channel axis")
        if block_len % (D * n_time):
            raise ValueError(f"block_len must be a multiple of {D * n_time}")
        params, state = cbank.build(cfg, input_format, device=device)
        if (params.lsb_sign is not None
                and block_len // (cfg.decim1 * n_time) < cfg.taps2_ssb - 1):
            raise ValueError(
                "SSB channels need a per-time-shard baseband slice of at "
                f"least taps2_ssb-1 = {cfg.taps2_ssb - 1} samples for the "
                "one-sided-decimator halo; raise block_len to at least "
                f"{cfg.decim1 * n_time * (cfg.taps2_ssb - 1)}")
        self.cfg = cfg
        self.mesh = mesh
        self.block_len = int(block_len)
        self.input_format = input_format
        self.n_loc = self.block_len // n_time
        # a mixed bank's coherent channels: the AM rows alone when the
        # channels are local to every rank, else every row and a mask
        self.coherent_mode = None
        if cfg.am_coherent and cbank._am_indices(cfg) and cfg.demod != "am":
            self.coherent_mode = "gather" if n_chan == 1 else "all"
        if self.coherent_mode == "all":
            # every channel row carries a front and a DC tracker
            C = cfg.nchan
            state = state._replace(
                front=lanes.tree_map(lambda v: v[:1].expand(C).contiguous(), state.front),
                dc=torch.zeros((C,), dtype=torch.float32, device=device))
        self.params, self.state = channel_slice(params, state, mesh)
        self._step_kw = dict(cfg=cfg, halo=halo, coherent_mode=self.coherent_mode,
                             am_idx=cbank._am_indices(cfg))

    @property
    def device(self) -> torch.device:
        return self.params.taps_re.device

    def __call__(self, iq):
        iq = torch.as_tensor(iq)
        if iq.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} samples")
        t = self.mesh.get_local_rank(TIME_AXIS)
        iq_loc = cbank.check_input(iq[t * self.n_loc:(t + 1) * self.n_loc],
                                   self.input_format, self.device)
        with annotate("ShardedBank.step"):
            state, audio = sharded_bank_step(self.params, self.state, iq_loc, self.mesh,
                                             **self._step_kw)
            self.state = broadcast_from_last(state, self.mesh)
            audio = all_gather(audio, self.mesh)                       # (T, C_loc, nj)
            audio = audio.permute(1, 0, 2).reshape(audio.shape[1], -1)
            audio = all_gather(audio, self.mesh, CHANNEL_AXIS)         # (n_chan, C_loc, N)
        return audio.reshape(-1, audio.shape[-1])
