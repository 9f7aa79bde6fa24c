"""The warmup-chunk lane scheme of the port's sequential scans, in plain
PyTorch (port of the layout shared by ``tpudsp/kernels/agc.py``
``agc_apply_chunked``, ``tpudsp/kernels/pll.py`` ``_chunked_scan`` and the
Pallas wrappers ``tpudsp/pallas/{agc_scan,am_backend_scan}.py``).

A batch x (C, L) is cut into nchunks = ceil(L / chunk) chunks per stream,
the last one zero-padded; stream c's chunk i lands on lane c*nchunks + i.
Each lane re-derives its entry state by running the loop over the
``warmup`` samples before its chunk, from its stream's carried state;
samples before the stream's start are masked out (the state passes
through), so a lane whose whole history fits in the window starts exactly.
All lanes then scan their chunk in parallel.

``chunked_scan`` is the plain version every CUDA scan kernel of the port
is held against (``csrc/scan_step.cuh`` lays its lanes out the same way):
a Python loop over the steps, vectorised over the lanes. The planes are
time-major (chunk, lanes), as the kernels read them. ``chunked_scan_mc``
is the same scan over the streams held as the columns of a (L, C) matrix,
read where they lie, with the lanes channel-minor (lane i*C + c), as the
matrix instance of ``csrc/am_front_scan.cu`` takes them.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """fn over the tensor leaves of nested NamedTuples / tuples / dicts
    (None leaves stay None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, *vs) for vs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def planes(x, chunk: int):
    """x (C, L) complex64 -> zero-padded (chunk, C*nchunks) f32 re and im
    planes (lane c*nchunks + i holds chunk i of stream c), nchunks, pad."""
    C, L = x.shape
    nchunks = -(-L // chunk)
    pad = nchunks * chunk - L
    xp = torch.nn.functional.pad(torch.view_as_real(x), (0, 0, 0, pad))
    p = xp.reshape(C * nchunks, chunk, 2).permute(2, 1, 0).contiguous()
    return p[0], p[1], nchunks, pad


def unplanes(v, C: int, L: int):
    """(chunk, C*nchunks) plane -> (C, L) in stream order."""
    return v.T.reshape(C, -1)[:, :L]


def unplanes_mc(v, C: int, L: int):
    """(chunk, nchunks*C) plane of channel-minor lanes -> (C, L) in stream
    order."""
    return v.reshape(v.shape[0], -1, C).permute(2, 1, 0).reshape(C, -1)[:, :L]


def per_stream(tree, C: int, k: int):
    """Per-lane leaves (C*nchunks,) -> chunk k (e.g. -1, the last) of each
    stream, (C,)."""
    return tree_map(lambda v: v.reshape(C, -1)[:, k].contiguous(), tree)


def per_stream_mc(tree, C: int, k: int):
    """Per-lane leaves (nchunks*C,) of channel-minor lanes -> chunk k of
    each stream, (C,): a view, no copy."""
    return tree_map(lambda v: v.view(-1, C)[k], tree)


def per_lane(tree, nchunks: int):
    """Per-stream leaves (C,) -> per-lane (C*nchunks,)."""
    return tree_map(lambda v: v.repeat_interleave(nchunks), tree)


def one_stream(tree):
    """Scalar leaves -> (1,) leaves: a one-stream batch."""
    return tree_map(lambda v: v.reshape(1), tree)


def first_stream(tree):
    """(C,) leaves -> the scalar leaves of stream 0."""
    return tree_map(lambda v: v[0], tree)


def warmup_windows(x, chunk: int, warmup: int, nchunks: int):
    """Materialised warmup windows of every lane: stream samples
    [i*chunk - warmup, i*chunk) as (warmup, lanes) f32 re and im planes,
    zeros before the stream's start, and each lane's first valid step
    t_start = warmup - min(warmup, i*chunk)."""
    C, L = x.shape
    dev = x.device
    flat = torch.nn.functional.pad(torch.view_as_real(x),
                                   (0, 0, warmup, nchunks * chunk - L))
    widx = (torch.arange(nchunks, device=dev) * chunk)[:, None] \
        + torch.arange(warmup, device=dev)[None, :]
    win = flat[:, widx].reshape(C * nchunks, warmup, 2).permute(2, 1, 0)
    ci = torch.arange(nchunks, device=dev).repeat(C)
    t_start = warmup - torch.clamp_max(ci * chunk, warmup)
    return win[0], win[1], t_start


def _scan(step, st, wre, wim, t_start, xre, xim):
    """The lanes' warmup (steps before t_start masked out), then their
    chunks. Returns (entry, final, outs)."""
    for t in range(wre.shape[0]):
        st2, _ = step(st, wre[t], wim[t])
        valid = t >= t_start
        st = tree_map(lambda a, b: torch.where(valid, a, b), st2, st)
    entry = st
    outs = []
    for t in range(xre.shape[0]):
        st, o = step(st, xre[t], xim[t])
        outs.append(o)
    outs = tuple(torch.stack(k) for k in zip(*outs))
    return entry, st, outs


def chunked_scan(step, state, x, chunk: int, warmup: int):
    """Run ``step(state, xr, xi) -> (state, outs)`` (outs a tuple of
    per-lane tensors) over the lanes of x (C, L) complex64 from per-stream
    state leaves (C,). Returns (entry, final, outs, nchunks, pad): the
    per-lane states after the warmup and after the chunk, and each output
    as a (chunk, lanes) plane."""
    xre, xim, nchunks, pad = planes(x, chunk)
    wre, wim, t_start = warmup_windows(x, chunk, warmup, nchunks)
    return _scan(step, per_lane(state, nchunks), wre, wim, t_start, xre, xim) + (nchunks, pad)


def chunked_scan_mc(step, state, Y, chunk: int, warmup: int):
    """``chunked_scan`` over the C streams held as the columns of Y (L, C)
    complex64, read in place: lane i*C + c carries chunk i of stream c, and
    step t of its warmup or chunk reads sample p = i*chunk - warmup + t or
    i*chunk + t of the stream, Y[p, c], zero outside [0, L). Returns
    (entry, final, outs, nchunks, pad), the lanes channel-minor."""
    L, C = Y.shape
    dev = Y.device
    nchunks = -(-L // chunk)
    i = torch.arange(nchunks, device=dev).repeat_interleave(C)
    c = torch.arange(C, device=dev).repeat(nchunks)
    yr = torch.view_as_real(Y)

    def read(p):
        v = yr[p.clamp(0, L - 1), c]
        v = torch.where(((p >= 0) & (p < L))[..., None], v, 0.0)
        return v[..., 0], v[..., 1]

    steps = lambda n: torch.arange(n, device=dev)[:, None]
    xre, xim = read(i * chunk + steps(chunk))
    wre, wim = read(i * chunk - warmup + steps(warmup))
    t_start = warmup - torch.clamp_max(i * chunk, warmup)
    st = tree_map(lambda v: v.repeat(nchunks), state)
    return _scan(step, st, wre, wim, t_start, xre, xim) + (nchunks, nchunks * chunk - L)


def exact_scan(step, state, x):
    """Run ``step`` sequentially over the last axis of x (..., N) complex64
    from state leaves shaped like x[..., 0]. Returns (state, outs), each
    output shaped like x."""
    xr = x.real.float()
    xi = x.imag.float()
    outs = []
    for t in range(x.shape[-1]):
        state, o = step(state, xr[..., t], xi[..., t])
        outs.append(o)
    return state, tuple(torch.stack(k, -1) for k in zip(*outs))
