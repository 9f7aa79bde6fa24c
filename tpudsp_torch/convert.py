"""Carry a JAX receiver's parameters and state over to the port.

``from_jax`` reads every leaf of the JAX package's ``AMParams`` /
``AMState`` with ``np.asarray`` and makes the port's tensors from it, so a
stream can move from a ``tpudsp`` receiver to a ``tpudsp_torch`` one
mid-flight; ``sharded_am_from_jax`` does it for a JAX
``ShardedAMReceiver``'s taps and ``SAMState``. ``op_state_from_jax`` does
the same for an op of the
reference class surface: it turns a ``tpudsp.compat`` op's ``.state`` (a
host numpy pytree) into the state of its ``tpudsp_torch.compat`` twin,
for ``with_state``. Neither imports jax: the JAX objects are only read by
attribute and type name.
"""

from __future__ import annotations

import numpy as np

from .chains.am import AMParams, AMState
from .kernels.agc import AgcParams, AgcState
from .kernels.am_backend import FrontState
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
