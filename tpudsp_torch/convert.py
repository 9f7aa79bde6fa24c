"""Carry a JAX receiver's parameters and state over to the port.

``from_jax`` reads every leaf of the JAX package's ``AMParams`` /
``AMState`` with ``np.asarray`` and makes the port's tensors from it, so a
stream can move from a ``tpudsp`` receiver to a ``tpudsp_torch`` one
mid-flight; ``sharded_am_from_jax`` does it for a JAX
``ShardedAMReceiver``'s taps and ``SAMState``; ``bank_from_jax``,
``stereo_from_jax`` and ``ssb_from_jax`` for a ``ReceiverBank``, a
``WBFMStereoReceiver`` and an ``SSBReceiver``; ``channelizer_from_jax``
and ``channelized_bank_from_jax`` for a ``Channelizer`` and a
``ChannelizedBank``; ``sharded_bank_from_jax``, ``tp_channelizer_from_jax``,
``tp_bank_from_jax``, ``scanner_from_jax`` and ``pipeline_from_jax`` for
the sharded runtimes, each JAX global array cut to this rank's slice
(they load the sharded runtime, ``tpudsp_torch.parallel``, when called).
``op_state_from_jax`` does
the same for an op of the
reference class surface: it turns a ``tpudsp.compat`` op's ``.state`` (a
host numpy pytree) into the state of its ``tpudsp_torch.compat`` twin,
for ``with_state``. Neither imports jax: the JAX objects are only read by
attribute and type name.
"""

from __future__ import annotations

import numpy as np

from .chains.am import AMParams, AMState
from .chains.bank import BankParams, BankState
from .chains.channelizer import ChannelizerState, DemodBankState
from .chains.ssb import SSBParams, SSBState
from .chains.wbfm import StereoParams, StereoState
from .kernels.agc import AgcParams, AgcState
from .kernels.am_backend import AmBackendParams, FrontState
from .kernels.ampmodem import AmpDemodState
from .kernels.hilbert import C2RState, DecimState, InterpState
from .kernels.pll import PllState, StereoPilotState
from .ops.base import to_tensor

# the port's state types, by the name of their JAX twins
_STATE_TYPES = {T.__name__: T for T in (AgcState, AmpDemodState, C2RState, DecimState,
                                        FrontState, InterpState, PllState,
                                        StereoPilotState)}


def _t(v, device):
    return None if v is None else to_tensor(v, device)


def op_state_from_jax(state, device="cuda"):
    """A JAX op's ``.state`` -> the port op's state on ``device``: every
    array leaf becomes a tensor with its dtype kept, except uint32 (a
    32-bit phase, a parity), which becomes int64 with the same value, as
    the port keeps it (torch cannot add uint32 tensors on the CPU); every
    NamedTuple becomes its port twin of the same name and fields, tuples
    and dicts stay tuples and dicts, and Python scalars (a resampler's
    ``tau``) stay as they are."""
    if isinstance(state, dict):
        return {k: op_state_from_jax(v, device) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        T = _STATE_TYPES[type(state).__name__]
        return T(*(op_state_from_jax(getattr(state, f), device) for f in T._fields))
    if isinstance(state, tuple):
        return tuple(op_state_from_jax(v, device) for v in state)
    if isinstance(state, (float, int)):
        return state
    if getattr(state, "dtype", None) == np.uint32:
        return to_tensor(np.asarray(state, np.int64), device)
    return _t(state, device)


def _am_params_from_jax(params, device):
    t = lambda v: _t(v, device)
    agc = AgcParams(*(t(getattr(params.agc, f)) for f in AgcParams._fields))
    return AMParams(*(agc if f == "agc" else t(getattr(params, f))
                      for f in AMParams._fields))


def from_jax(params, state, device="cuda"):
    """JAX ``AMParams``, ``AMState`` -> the port's (AMParams, AMState) on
    ``device``, leaf for leaf with dtypes kept."""
    t = lambda v: _t(v, device)
    new_params = _am_params_from_jax(params, device)
    new_state = AMState(
        fir_tail=t(state.fir_tail),
        rs_tail=t(state.rs_tail),
        agc=op_state_from_jax(state.agc, device),
        am=op_state_from_jax(state.am, device),
        deemph=t(state.deemph),
    )
    return new_params, new_state


def sharded_am_from_jax(taps, state, device="cuda"):
    """A JAX ``ShardedAMReceiver``'s taps (its ``_taps``: an array, or a
    tuple of arrays) and ``SAMState`` -> the port receiver's ``taps`` and
    ``state`` on ``device``, leaf for leaf with dtypes kept."""
    from .parallel.am import SAMState   # the sharded runtime, only here
    if isinstance(taps, tuple):
        taps = tuple(_t(v, device) for v in taps)
    else:
        taps = _t(taps, device)
    return taps, SAMState(rs_tail=_t(state.rs_tail, device),
                          front=op_state_from_jax(state.front, device),
                          dc=_t(state.dc, device),
                          deemph=_t(state.deemph, device))


def _named(T, obj, device, **given):
    """The port's NamedTuple ``T`` from a JAX one read field by field: the
    fields in ``given`` as they are, every other leaf as
    ``op_state_from_jax`` converts it (uint32 to int64, None kept)."""
    return T(*(given[f] if f in given else op_state_from_jax(getattr(obj, f), device)
               for f in T._fields))


def bank_from_jax(params, state, device="cuda"):
    """JAX ``BankParams``, ``BankState`` (a ReceiverBank's ``params`` and
    ``state``) -> the port's on ``device``: leaf for leaf with dtypes kept,
    the uint32 ``dtheta``, ``phase`` and ``n0`` as int64, the coherent AM
    back end's linear coefficients as Python floats, as the port keeps
    them."""
    return (_named(BankParams, params, device, amb=_amb_from_jax(params.amb, device)),
            _named(BankState, state, device))


def _amb_from_jax(amb, device):
    """A JAX bank's coherent AM back-end parameters (or None) -> the port's,
    the linear coefficients as Python floats."""
    if amb is None:
        return None
    return _named(AmBackendParams, amb, device, agc=_named(AgcParams, amb.agc, device),
                  **{f: float(np.asarray(getattr(amb, f)))
                     for f in ("dc_rho", "deemph_b0", "deemph_a")})


def stereo_from_jax(params, state, device="cuda"):
    """A JAX ``WBFMStereoReceiver``'s ``_params`` (the tuple h1, h2, h_aud,
    dtheta, b0, a) and ``state`` (``StereoState``) -> the port's
    ``StereoParams`` (the pilot increment a host int) and ``StereoState``
    on ``device``."""
    h1, h2, h_aud, dtheta, b0, a = params
    t = lambda v: _t(v, device)
    return (StereoParams(t(h1), t(h2), t(h_aud), int(np.asarray(dtheta)), t(b0), t(a)),
            _named(StereoState, state, device))


def ssb_from_jax(params, state, device="cuda"):
    """JAX ``SSBParams``, ``SSBState`` (an SSBReceiver's ``params`` and
    ``state``) -> the port's on ``device``, leaf for leaf."""
    return (_named(SSBParams, params, device, agc=_named(AgcParams, params.agc, device)),
            _named(SSBState, state, device))


def channelizer_from_jax(Ht, state, device="cuda"):
    """A JAX ``Channelizer``'s ``Ht`` and ``ChannelizerState`` -> the port's
    (Ht, ChannelizerState) on ``device``, the tail's dtype kept (complex64,
    or raw int16 / uint8)."""
    return _t(Ht, device), ChannelizerState(tail=_t(state.tail, device))


def channelized_bank_from_jax(params, state, device="cuda"):
    """A JAX ``ChannelizedBank``'s ``params`` (Ht, b0, a, amb, fm_mask) and
    ``DemodBankState`` -> the port's on ``device``, leaf for leaf with
    dtypes kept, the coherent AM back end's linear coefficients as Python
    floats, as the port keeps them."""
    Ht, b0, a, amb, fm_mask = params
    Ht, ch = channelizer_from_jax(Ht, state.ch, device)
    return ((Ht, _t(b0, device), _t(a, device), _amb_from_jax(amb, device),
             _t(fm_mask, device)),
            _named(DemodBankState, state, device, ch=ch))


def sharded_bank_from_jax(params, state, mesh, device="cuda"):
    """A JAX ``ShardedBank``'s ``params`` and ``state`` (global arrays) ->
    this rank's (BankParams, BankState) of the port's ``ShardedBank`` on
    ``mesh``: ``bank_from_jax``, then the per-channel leaves cut to the
    rank's ``channel`` slice (``parallel/bank.channel_slice``)."""
    from .parallel.bank import channel_slice
    return channel_slice(*bank_from_jax(params, state, device), mesh)


def _axis_slice(mesh, axis_name):
    """(this rank's index along ``axis_name``, the axis's size)."""
    from .parallel.mesh import axis_size
    return mesh.get_local_rank(axis_name), axis_size(mesh, axis_name)


def tp_channelizer_from_jax(Ht, tw, tail, mesh, axis_name: str, device="cuda"):
    """A JAX ``ShardedChannelizer``'s ``Ht``, ``tw`` (C1, C2) and ``tail``
    -> the port's (Ht, this rank's (C1, C2/n) twiddle columns, tail) for
    the rank's place on ``axis_name``."""
    r, n = _axis_slice(mesh, axis_name)
    tw = np.asarray(tw)
    w = tw.shape[1] // n
    return _t(Ht, device), _t(tw[:, r * w:(r + 1) * w], device), _t(tail, device)


def tp_bank_from_jax(params, state, mesh, axis_name: str, device="cuda"):
    """A JAX ``ShardedChannelizedBank``'s ``params`` (Ht, tw, b0, a, amb,
    fm_mask) and ``TPBankState`` (layout-ordered (C1, C2) leaves) -> the
    port's, each (C1, C2) leaf cut to this rank's rows of c1 and the
    twiddle to its columns of p2."""
    from .parallel.channelizer import TPBankState
    Ht, tw, b0, a, amb, fm_mask = params
    r, n = _axis_slice(mesh, axis_name)
    rows = lambda v: None if v is None else np.asarray(v)[
        r * (np.shape(v)[0] // n):(r + 1) * (np.shape(v)[0] // n)]
    Ht, tw, tail = tp_channelizer_from_jax(Ht, tw, state.tail, mesh, axis_name, device)
    cut = lambda tree: op_state_from_jax(_leaves_map(rows, tree), device)
    return ((Ht, tw, _t(b0, device), _t(a, device), _amb_from_jax(amb, device),
             _t(rows(fm_mask), device)),
            TPBankState(tail=tail, fd_prev=_t(rows(state.fd_prev), device),
                        deemph=_t(rows(state.deemph), device), front=cut(state.front),
                        dc=_t(rows(state.dc), device)))


def _leaves_map(fn, tree):
    """fn over the array leaves of a JAX NamedTuple tree (None kept), the
    NamedTuples kept as they are."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        vals = [_leaves_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


def scanner_from_jax(params, state, device="cuda"):
    """A JAX ``ShardedScanner``'s ``params`` and ``DemodBankState`` (held
    whole on every rank) -> the port's, as ``channelized_bank_from_jax``."""
    return channelized_bank_from_jax(params, state, device)


def pipeline_from_jax(params, state, stages):
    """A JAX ``PipelinedAMReceiver``'s ``params`` (AMParams) and
    ``AMPipeState`` (stage-stacked leaves) -> the port's per-stage
    AMParams and AMPipeState on the two stage devices: stage 0's front-end
    tail, stage 1's AGC, AmpModem, de-emphasis and activation."""
    from .parallel.pipeline import AMPipeState
    d0, d1 = stages
    stage1 = lambda tree: op_state_from_jax(
        _leaves_map(lambda v: np.asarray(v)[1], tree), d1)
    return (_am_params_from_jax(params, d0), _am_params_from_jax(params, d1)), AMPipeState(
        rs_tail=_t(np.asarray(state.rs_tail)[0], d0),
        agc=stage1(state.agc), am=stage1(state.am),
        deemph=_t(np.asarray(state.deemph)[1], d1),
        buf=_t(np.asarray(state.buf)[1], d1))
