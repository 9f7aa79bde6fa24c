"""Carry a JAX receiver's parameters and state over to the port.

``from_jax`` reads every leaf of the JAX package's ``AMParams`` /
``AMState`` with ``np.asarray`` and makes the port's tensors from it, so a
stream can move from a ``tpudsp`` receiver to a ``tpudsp_torch`` one
mid-flight. It imports no jax: the JAX objects are only read by attribute.
The demod state's c2r Hilbert leaves are dropped (the port's dsb chain has
none, kernels/ampmodem.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .chains.am import AMParams, AMState
from .kernels.agc import AgcParams, AgcState
from .kernels.ampmodem import AmpDemodState
from .kernels.pll import PllState


def _t(v, device):
    return None if v is None else torch.from_numpy(np.array(v)).to(device)


def from_jax(params, state, device=None):
    """JAX ``AMParams``, ``AMState`` -> the port's (AMParams, AMState) on
    ``device``, leaf for leaf with dtypes kept."""
    t = lambda v: _t(v, device)
    agc = AgcParams(*(t(getattr(params.agc, f)) for f in AgcParams._fields))
    new_params = AMParams(*(agc if f == "agc" else t(getattr(params, f))
                            for f in AMParams._fields))
    new_state = AMState(
        fir_tail=t(state.fir_tail),
        rs_tail=t(state.rs_tail),
        agc=AgcState(*(t(getattr(state.agc, f)) for f in AgcState._fields)),
        am=AmpDemodState(pll=PllState(t(state.am.pll.theta),
                                      t(state.am.pll.freq)),
                         dc=t(state.am.dc)),
        deemph=t(state.deemph),
    )
    return new_params, new_state
