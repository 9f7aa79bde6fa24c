"""Carry a JAX receiver's parameters and state over to the port.

``from_jax`` reads every leaf of the JAX package's ``AMParams`` /
``AMState`` with ``np.asarray`` and makes the port's tensors from it, so a
stream can move from a ``tpudsp`` receiver to a ``tpudsp_torch`` one
mid-flight; ``sharded_am_from_jax`` does it for a JAX
``ShardedAMReceiver``'s taps and ``SAMState``; ``bank_from_jax``,
``stereo_from_jax`` and ``ssb_from_jax`` for a ``ReceiverBank``, a
``WBFMStereoReceiver`` and an ``SSBReceiver``; ``channelizer_from_jax``
and ``channelized_bank_from_jax`` for a ``Channelizer`` and a
``ChannelizedBank``. ``op_state_from_jax`` does
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


def from_jax(params, state, device="cuda"):
    """JAX ``AMParams``, ``AMState`` -> the port's (AMParams, AMState) on
    ``device``, leaf for leaf with dtypes kept."""
    t = lambda v: _t(v, device)
    agc = AgcParams(*(t(getattr(params.agc, f)) for f in AgcParams._fields))
    new_params = AMParams(*(agc if f == "agc" else t(getattr(params, f))
                            for f in AMParams._fields))
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
