"""Cross-shard helpers of the time-sharded runtime (port of the two
time-axis helpers of ``tpudsp/parallel/bank.py``).

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

The sharded receiver bank itself (``sharded_bank_step``, ``ShardedBank``)
needs the bank chain, ``chains/bank.py``, ROADMAP.md Queue A #9, and is
not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..cuda import am_backend_scan as scan
from ..cuda import first_order
from ..kernels import iir as kiir
from ..kernels.ampmodem import DC_RHO
from ..kernels.warmup import chunk_for
from .halo import left_halo
from .mesh import TIME_AXIS, axis_size

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
