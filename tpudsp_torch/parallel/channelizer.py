"""The channelizer with its channel transform split across ranks (port of
``tpudsp/parallel/channelizer.py``): the four-step distributed IFFT.

Factor C = C1 * C2 and write branch p = p1*C2 + p2, channel c = c2*C1 + c1:

    S[c2*C1 + c1] = sum_p2 e^{2 pi j p2 c2 / C2}
                      [ e^{2 pi j p2 c1 / C}            (twiddle)
                        * sum_p1 e^{2 pi j p1 c1 / C1} u[p1*C2 + p2] ]

so the C-point transform becomes C1-point IFFTs batched over p2, a
twiddle, a transpose, then C2-point IFFTs batched over c1. One axis of the
mesh plays both roles:

  1. the input is split in time: each rank frames its slice and runs the
     polyphase branch sum locally (``cuda/pfb.branch_accumulate``, the
     pfb_branch kernel on the card), with the left neighbour's last
     (T-1) C + C-1 samples as its tail (one halo exchange, ``halo.py``);
  2. transpose 1 (frames -> p2 slices): one ``all_to_all_single``;
  3. the local stage-1 IFFT over p1, then the twiddle at the global p2;
  4. transpose 2 (p2 slices -> c1 slices): one more ``all_to_all_single``;
  5. the local stage-2 IFFT over p2: Y[m, c1_loc, c2], every frame of the
     block for this rank's c1 slice, which is what a per-channel demod
     bank wants (no further communication).

The transposes move the split axis to the front, make it contiguous and
cross as real views (``torch.view_as_real``) on the axis's group: NCCL
between cards, gloo between CPU processes. The local IFFTs are
``torch.fft.ifft(..., norm="forward")``, the unscaled inverse, as the
single-card channelizer's.

Channel c lives at layout position [c1, c2] with c1 = c % C1, c2 = c // C1
(``channel_layout`` maps between the orders). On a one-rank axis (a
``LocalMesh``, or an axis of size 1) no collective runs; with c1 > 1 the
twiddle and both transform stages still run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..chains import channelizer as cch
from ..chains.am import INPUT_FORMATS
from ..chains.bank import _fm_base, check_input
from ..chains.channelizer import ChannelizedBankConfig, ChannelizerConfig
from ..cuda import first_order, pfb
from ..cuda.am_backend_scan import front_chunked
from ..design import iirdes
from ..kernels import agc as kagc
from ..kernels import am_backend as kab
from ..kernels import ampmodem as kam
from ..kernels import lanes
from ..kernels import warmup as kwarm
from ..kernels.fastmath import patan2
from ..kernels.pll import PllState
from ..utils.profiling import annotate
from .bank import all_gather
from .halo import left_halo_rows
from .mesh import axis_size

TWO_PI = 2.0 * np.pi


def channel_layout(C1: int, C2: int):
    """Map (c1, c2) layout order -> natural channel order.

    Returns ``perm`` with ``perm[i] = c2*C1 + c1`` for layout position
    ``i = c1*C2 + c2``: scatter ``Y_nat[:, perm] = Y_layout.reshape(M, C)``
    recovers natural channel order.
    """
    c1 = np.repeat(np.arange(C1), C2)
    c2 = np.tile(np.arange(C2), C1)
    return c2 * C1 + c1


def _factor(C: int, n_shards: int, c1: int | None):
    if c1 is None:
        # the smallest C1 that keeps both stage batches shardable
        c1 = n_shards
        while C % c1 or (C // c1) % n_shards:
            c1 += n_shards
            if c1 > C:
                raise ValueError(f"cannot factor C={C} over {n_shards} shards")
    C1, C2 = c1, C // c1
    if C1 * C2 != C or C1 % n_shards or C2 % n_shards:
        raise ValueError(
            f"need C1*C2={C} with C1, C2 both multiples of {n_shards}; "
            f"got C1={C1}, C2={C2}")
    return C1, C2


def _frontend_local(Ht, halo_tail, x_loc, os: int = 1):
    """The polyphase branch sum over this rank's time slice, with
    ``halo_tail`` the (T-1) C + C-1 samples before it in the stream:
    u_loc (M_loc, C) of the frames this rank owns (M_loc = os N_loc / C),
    one pfb_branch launch on the card. Raw wire slices ((N_loc, 2) int16 /
    uint8, Ht carrying the wire scale) frame at wire width; the kernel
    subtracts uint8's 127.5 offset per branch.

    At os=2 the odd frames' phase factor e^{-j pi c} is applied here, in
    the branch domain, as a circular C/2 roll of u (rolling u by C/2
    multiplies the post-IFFT channel c by (-1)^c), so the distributed
    transform needs no channel-indexed correction. Local frame parity is
    global parity only because every rank owns an even frame count
    (``ShardedChannelizer`` checks it)."""
    u = pfb.branch_accumulate(Ht, halo_tail.contiguous(), x_loc, os)
    if os == 2:
        u[1::2] = torch.roll(u[1::2], -(Ht.shape[1] // 2), dims=1)
    return u


def _all_to_all(x, split: int, concat: int, mesh, axis: str):
    """``lax.all_to_all(x, axis, split, concat, tiled=True)``: split
    dimension ``split`` of this rank's complex64 x into n equal parts,
    send part j to rank j of ``axis`` and concatenate what arrives along
    ``concat`` in rank order. One ``all_to_all_single`` of the real view,
    the split dimension moved to the front and made contiguous."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    parts = x.unflatten(split, (n, x.shape[split] // n)).movedim(split, 0)
    send = torch.view_as_real(parts.contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(axis))
    # got[j]: rank j's part, which goes j-th along ``concat``
    got = torch.view_as_complex(recv)
    return got.movedim(0, concat).flatten(concat, concat + 1)


def tp_channelize_shard(Ht, tw, tail, x_loc, mesh, *, C1: int, C2: int,
                        axis_name: str, os: int = 1):
    """This rank's part of the distributed channelizer. Ht: (T, C)
    prototype branches; tw: (C1, C2 / n) this rank's twiddle columns e^{2
    pi j c1 p2 / C} at its global p2 block; tail: the block-carried
    ((T-1) C + C-1,) samples (or raw (.., 2)), rank 0's left fill; x_loc:
    this rank's time slice. Returns Y_loc (M, C1 / n, C2), the channel
    axis split over c1."""
    halo = left_halo_rows(x_loc, tail.shape[0], mesh, tail, axis_name)
    u = _frontend_local(Ht, halo, x_loc, os)                  # (M_loc, C)
    u = u.reshape(u.shape[0], C1, C2)
    # transpose 1: frame slices -> p2 slices
    u = _all_to_all(u, 2, 0, mesh, axis_name)                 # (M, C1, C2/n)
    # stage 1: the C1-point transform over p1, batched over (m, p2_loc)
    A = torch.fft.ifft(u, dim=1, norm="forward") * tw[None]
    # transpose 2: p2 slices -> c1 slices
    A = _all_to_all(A, 1, 2, mesh, axis_name)                 # (M, C1/n, C2)
    # stage 2: the C2-point transform over p2, batched over (m, c1_loc)
    return torch.fft.ifft(A, dim=2, norm="forward")


def _twiddle(C1: int, C2: int, n: int, r: int, device):
    """This rank's (C1, C2 / n) twiddle columns, from float64."""
    c1g = np.arange(C1)[:, None]
    p2g = np.arange(r * (C2 // n), (r + 1) * (C2 // n))[None, :]
    return torch.tensor(np.exp(2j * np.pi * c1g * p2g / (C1 * C2)).astype(np.complex64),
                        device=device)


class ShardedChannelizer:
    """The analysis channelizer with its channel transform split over one
    mesh axis, one rank per process. Every rank is given the whole block
    and takes its time slice along ``axis_name`` (the mesh's first axis
    unless named); ``__call__`` returns the (M, C) channel matrix in
    natural channel order on every rank (one all_gather; ``step``
    returns this rank's (M, C1/n, C2) layout slice instead, for chaining
    into a demod bank). The design and the carried tail live on
    ``device``, the card unless the caller asks for the CPU.
    ``convert.tp_channelizer_from_jax`` carries a JAX channelizer's taps,
    twiddles and tail over."""

    def __init__(self, cfg: ChannelizerConfig, mesh, block_len: int,
                 axis_name: str | None = None, c1: int | None = None,
                 input_format: str = "c64", *, device="cuda"):
        if cfg.engine != "shift":
            raise NotImplementedError(
                "the sharded channelizer front end implements the 'shift' "
                f"PFB accumulation only; engine={cfg.engine!r} would be "
                "silently mis-measured (use chains.channelizer for the "
                "conv engine, or engine='shift' here)")
        if input_format not in INPUT_FORMATS:
            raise ValueError(f"unknown input_format {input_format!r} "
                             "(use 'c64', 'i16' or 'u8')")
        if axis_name is None:
            axis_name = mesh.mesh_dim_names[0]
        n = axis_size(mesh, axis_name)
        C = cfg.nchan
        if block_len % (C * n):
            raise ValueError(f"block_len must be a multiple of {C * n}")
        if block_len // n < cfg.taps_per_branch * C:
            raise ValueError(
                "per-shard slice must cover the frame halo: need "
                f"block_len >= {cfg.taps_per_branch * C * n}")
        if (cfg.oversample * (block_len // n) // C) % cfg.oversample:
            # the odd-frame roll takes local frame parity for global parity
            raise ValueError("every rank must own an even frame count at os=2")
        self.cfg = cfg
        self.mesh = mesh
        self.axis_name = axis_name
        self.block_len = int(block_len)
        self.input_format = input_format
        self.n_loc = self.block_len // n
        self.C1, self.C2 = _factor(C, n, c1)
        self.layout_perm = channel_layout(self.C1, self.C2)
        r = mesh.get_local_rank(axis_name)
        self.Ht, st = cch.build(cfg, input_format, device=device)
        self.tail = st.tail
        self.tw = _twiddle(self.C1, self.C2, n, r, device)
        # natural order from layout order: Y_nat = Y_layout[:, inv]
        self._inv = torch.tensor(np.argsort(self.layout_perm), device=device)

    @property
    def device(self) -> torch.device:
        return self.Ht.device

    def _local(self, iq, tail):
        """This rank's slice of the whole block, checked and on the device,
        and the tail after the block (``tail`` ++ the block's last
        samples): every rank holds the whole block, so each makes the last
        rank's tail itself."""
        iq = torch.as_tensor(iq)
        if iq.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} samples")
        r = self.mesh.get_local_rank(self.axis_name)
        x = check_input(iq[r * self.n_loc:(r + 1) * self.n_loc], self.input_format,
                        self.device)
        htail = tail.shape[0]
        end = check_input(iq[-htail:], self.input_format, self.device)
        return x, torch.cat([tail, end])[-htail:]

    def step(self, iq):
        """This rank's (M, C1/n, C2) layout slice of the block's channels."""
        x, tail = self._local(iq, self.tail)
        Y = tp_channelize_shard(self.Ht, self.tw, self.tail, x, self.mesh, C1=self.C1,
                                C2=self.C2, axis_name=self.axis_name,
                                os=self.cfg.oversample)
        self.tail = tail
        return Y

    def __call__(self, iq):
        Y = all_gather(self.step(iq), self.mesh, self.axis_name)    # (n, M, C1/n, C2)
        M = Y.shape[1]
        Yl = Y.permute(1, 0, 2, 3).reshape(M, self.cfg.nchan)
        return Yl.index_select(1, self._inv)


class TPBankState(NamedTuple):
    tail: torch.Tensor     # ((T-1) C + C-1,) carried stream tail (or raw (.., 2))
    fd_prev: torch.Tensor  # (C1/n, C2) complex64, layout order, this rank's c1 slice
    deemph: torch.Tensor   # (C1/n, C2) f32
    front: object = None   # kab.FrontState, leaves (C1/n, C2) (coherent AM)
    dc: object = None      # (C1/n, C2) f32 DC-tracker carry (coherent AM)


def tp_bank_shard(params, state: TPBankState, x_loc, mesh, *,
                  cfg: ChannelizedBankConfig, C1: int, C2: int, axis_name: str):
    """The distributed channelizer, then the demod bank on this rank's
    channels. After transpose 2 every rank holds the whole block's frames
    for its channels, so the back end (coherent AM's feedback scans
    included) runs with no further communication. params: (Ht, tw, b0, a,
    amb, fm_mask); fm_mask, for a mixed bank, is this rank's (C1/n, C2)
    slice in layout order. Returns (state, audio (C1/n, C2, M))."""
    Ht, tw, _, _, amb, fm_mask = params
    Y = tp_channelize_shard(Ht, tw, state.tail, x_loc, mesh, C1=C1, C2=C2,
                            axis_name=axis_name, os=cfg.channelizer.oversample)
    M, c1_loc, c2 = Y.shape
    c_loc = c1_loc * c2
    Ymc = Y.reshape(M, c_loc)                      # frames x this rank's channels
    b0_de, a_de = iirdes.deemphasis_coeffs(cfg.channelizer.chan_rate, cfg.deemph_tau)
    mixed = cch._is_mixed(cfg)
    front, dc = state.front, state.dc
    if not mixed and cch._demod_tuple(cfg)[0] == "fm":
        # the uniform-FM bank on the (M, c_loc) columns, as the single-card
        # bank runs it: the discriminator, then one column-carry launch
        prev = torch.cat([state.fd_prev.reshape(1, c_loc), Ymc[:-1]], 0)
        d = Ymc * torch.conj(prev)
        base_mc = patan2(d.imag, d.real) / float(np.float32(TWO_PI * cfg.kd))
        deemph, audio_mc = first_order.first_order_apply_blocked_mc(
            b0_de, a_de, state.deemph.reshape(c_loc), base_mc)
        audio = audio_mc.T
    else:
        Yc = Ymc.T.contiguous()                    # (c_loc, M)

        def coherent():
            w = kwarm.warmup_for(agc_alpha=cfg.agc_bandwidth, pll_bw=kam.PLL_BW)
            fr, (vr, _modes) = front_chunked(
                amb, lanes.tree_map(lambda v: v.reshape(c_loc), state.front), Yc,
                kwarm.chunk_for(w), w)
            dc2, dct = first_order.first_order_apply_blocked(
                1.0 - kam.DC_RHO, kam.DC_RHO, state.dc.reshape(c_loc), vr)
            return (lanes.tree_map(lambda v: v.reshape(c1_loc, c2), fr),
                    dc2.reshape(c1_loc, c2), (vr - dct) * amb.inv_mod)

        if not mixed and cfg.am_coherent:
            front, dc, base = coherent()
        elif not mixed:
            base = torch.abs(Yc)
        else:
            # mixed: the local AM rows are not known in advance, so the
            # coherent back end (when on) runs on every local row and the
            # layout-ordered mask selects
            m = fm_mask.reshape(c_loc, 1)
            base = torch.where(m, _fm_base(Yc, state.fd_prev.reshape(c_loc), cfg.kd),
                               torch.abs(Yc))
            if cfg.am_coherent and cch._am_indices(cfg):
                front, dc, coh = coherent()
                base = torch.where(m, base, coh)
        deemph, audio = first_order.first_order_apply_blocked(
            b0_de, a_de, state.deemph.reshape(c_loc), base)
    new_state = TPBankState(tail=state.tail, fd_prev=Y[-1].clone(),
                            deemph=deemph.reshape(c1_loc, c2), front=front, dc=dc)
    return new_state, audio.reshape(c1_loc, c2, M)


class ShardedChannelizedBank:
    """The channelized demod bank with the channel transform split across
    ranks and the demod bank channel-parallel behind it, one rank per
    process. Every rank is given the whole block; ``__call__`` returns the
    (C, M) audio in natural channel order on every rank (one all_gather;
    ``step`` returns this rank's (C1/n, C2, M) layout slice). The design
    and state live on ``device``, the card unless the caller asks for the
    CPU. ``convert.tp_bank_from_jax`` carries a JAX bank's parameters and
    state over."""

    def __init__(self, cfg: ChannelizedBankConfig, mesh, block_len: int,
                 axis_name: str | None = None, c1: int | None = None,
                 input_format: str = "c64", *, device="cuda"):
        ccfg = cfg.channelizer
        sc = ShardedChannelizer(ccfg, mesh, block_len, axis_name, c1, input_format,
                                device=device)
        self.cfg = cfg
        self.mesh = mesh
        self.axis_name = sc.axis_name
        self.block_len = sc.block_len
        self.input_format = input_format
        self.C1, self.C2 = sc.C1, sc.C2
        self.layout_perm = sc.layout_perm
        self._sc = sc
        n = axis_size(mesh, self.axis_name)
        r = mesh.get_local_rank(self.axis_name)
        rows = slice(r * (self.C1 // n), (r + 1) * (self.C1 // n))
        shp = (self.C1 // n, self.C2)
        b0, a = iirdes.deemphasis_coeffs(ccfg.chan_rate, cfg.deemph_tau)
        fm_mask = amb = front0 = dc0 = None
        if cch._is_mixed(cfg):
            nat = np.asarray([d == "fm" for d in cch._demod_tuple(cfg)])
            fm_mask = torch.tensor(nat[self.layout_perm].reshape(self.C1, self.C2)[rows],
                                   device=device)
        if cfg.am_coherent and cch._am_indices(cfg):
            amb = kab.make_params(
                kagc.make_params(alpha=cfg.agc_bandwidth, scale=cfg.agc_scale,
                                 device=device),
                cfg.modulation, b0, a, carrier=True)
            zeros = lambda: torch.zeros(shp, dtype=torch.float32, device=device)
            front0 = kab.FrontState(
                agc=lanes.tree_map(lambda v: v.expand(shp).contiguous(),
                                   kagc.agc_init(device=device)),
                pll=PllState(zeros(), zeros()))
            dc0 = zeros()
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        self.params = (sc.Ht, sc.tw, f32(b0), f32(a), amb, fm_mask)
        self.state = TPBankState(
            tail=sc.tail,
            fd_prev=torch.full(shp, 1.0 + 0.0j, dtype=torch.complex64, device=device),
            deemph=torch.zeros(shp, dtype=torch.float32, device=device),
            front=front0, dc=dc0)

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def step(self, iq):
        """This rank's (C1/n, C2, M) layout slice of the block's audio."""
        x, tail = self._sc._local(iq, self.state.tail)
        state, audio = tp_bank_shard(self.params, self.state, x, self.mesh, cfg=self.cfg,
                                     C1=self.C1, C2=self.C2, axis_name=self.axis_name)
        self.state = state._replace(tail=tail)
        return audio

    def __call__(self, iq):
        with annotate("ShardedChannelizedBank.step"):
            a = all_gather(self.step(iq), self.mesh, self.axis_name)   # (n, C1/n, C2, M)
        return a.reshape(self.C1 * self.C2, -1).index_select(0, self._sc._inv)
