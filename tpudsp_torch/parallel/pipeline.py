"""Stage parallelism: the AM receiver's two stages on two devices, blocks
streamed through (port of ``tpudsp/parallel/pipeline.py``).

The AM chain splits at its natural compute boundary:

  stage 0: the fused bandpass + resampler front end at the input rate;
  stage 1: AGC -> AmpModem (carrier PLL) -> de-emphasis at the pcm rate
           (``chains/am._back_end``).

Where the JAX receiver runs both stages in one SPMD step over a 2-device
``stage`` mesh axis, the port uses PyTorch's idiom for stages: one
process holding two stage devices, each stage on a CUDA stream of its own.
At call t the host enqueues stage 1 on block t-1's activation, then stage
0 on block t, then hands block t's activation to stage 1's device with a
``non_blocking`` copy ordered after stage 0 by an event. Stage 0 of block
t+1 and stage 1 of block t then run at once (one-block latency, a fill
bubble at the stream's start, a drain at its end). Both stages may be
named on one card (``("cuda:0", "cuda:0")``): each still has its own
stream. Each stage's stream comes from the pool the io runtime draws from
(``io.stream._own_stream``): no live StreamRuntime or other receiver
holds it, since ``cuda/launch.chain``'s bookkeeping is per stream and
thread.

The streamed output equals the single-device AMReceiver's (fused plan,
same exact / backend settings) bit for bit: the stages run the same
launches in the same order on the same values.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import NamedTuple

import torch

from ..chains.am import (AMConfig, AMParams, AMState, INPUT_FORMATS, _back_end,
                         _check_back_end, _rational, build)
from ..kernels import decimate as kdec
from ..kernels import lanes

N_STAGES = 2


class AMPipeState(NamedTuple):
    rs_tail: torch.Tensor   # stage 0: the fused front end's input tail (c64, or raw (kf, 2))
    agc: object             # stage 1: AgcState
    am: object              # stage 1: AmpDemodState
    deemph: torch.Tensor    # stage 1: f32 de-emphasis carry
    buf: torch.Tensor       # stage 1: (n_out,) complex64, the activation in flight


class _Stage(NamedTuple):
    device: torch.device
    stream: object          # torch.cuda.Stream, or None on the CPU


def make_stage_mesh(devices=None):
    """The two stage devices: the first two cards unless ``devices`` names
    them (a pair, e.g. ("cuda:0", "cuda:0") for both stages on one card,
    or ("cpu", "cpu")). Raises with fewer than two."""
    if devices is None:
        n = torch.cuda.device_count()
        if n < N_STAGES:
            raise ValueError(f"pipeline needs {N_STAGES} devices, {n} cards found "
                             "(name the stage devices to run both on one)")
        devices = [f"cuda:{i}" for i in range(N_STAGES)]
    if len(devices) < N_STAGES:
        raise ValueError(f"pipeline needs {N_STAGES} devices")
    return tuple(torch.device(d) for d in devices[:N_STAGES])


def _front(params: AMParams, rs_tail, iq, Q: int, nj: int):
    """Stage 0: the fused front end (wire samples convert inside it, so
    only stage 0 touches them)."""
    if rs_tail.dtype == torch.uint8:
        return kdec.fused_frontend_apply_shared_u8(params.taps_fused, params.u8_dc,
                                                   rs_tail, iq, Q, nj)
    if rs_tail.dtype == torch.int16:
        return kdec.fused_frontend_apply_shared_i16(params.taps_fused, rs_tail, iq, Q, nj)
    return kdec.fused_frontend_apply_shared(params.taps_fused, rs_tail, iq, Q, nj)


def _on(stage: _Stage):
    return contextlib.nullcontext() if stage.stream is None else torch.cuda.stream(stage.stream)


def pipeline_step(params, state: AMPipeState, iq, valid: bool, *, cfg: AMConfig,
                  exact: bool, backend: str, n_out: int, stages):
    """One call: stage 1 on the activation in flight (block t-1), stage 0
    on ``iq`` (block t, on stage 0's device), the hand-over. params: the
    AMParams of each stage, on its device; stages: the two ``_Stage``s.
    ``valid`` is False only on the fill call, when the buffer holds no
    block yet: stage 1 is then an identity (silence would wind the AGC
    gain up before the first real block arrives). Returns (state, block
    t-1's pcm on stage 1's device, or None on the fill call)."""
    s0, s1 = stages
    P, Q = _rational(cfg.rate)
    pcm = None
    agc, am, deemph = state.agc, state.am, state.deemph
    with _on(s1):
        if valid:
            back_in = AMState(fir_tail=None, rs_tail=None, agc=agc, am=am, deemph=deemph)
            agc, am, deemph, pcm, _modes = _back_end(params[1], back_in, state.buf, cfg,
                                                     exact, backend)
    with _on(s0):
        rs_tail, act = _front(params[0], state.rs_tail, iq, Q, n_out // P)
    with _on(s1):
        if s0.stream is not None:
            # the hand-over: stage 1's stream waits for stage 0's work on
            # this block, then copies the activation to its device
            s1.stream.wait_stream(s0.stream)
            act.record_stream(s1.stream)
        buf = torch.empty(n_out, dtype=torch.complex64, device=s1.device)
        buf.copy_(act, non_blocking=True)
    return AMPipeState(rs_tail, agc, am, deemph, buf), pcm


class PipelinedAMReceiver:
    """The AM receiver with its front end and back end on two stage
    devices, one IQ block in flight.

    ``__call__(iq)`` returns the pcm of the PREVIOUS block (None on the
    first call), on stage 1's device; ``flush()`` drains the last block
    with a zero feed (127 for uint8) and resets the receiver. ``mesh`` is
    the stage devices (``make_stage_mesh``; the first two cards unless
    given). The streamed output equals the single-device AMReceiver's
    (fused plan, same ``exact`` / ``backend``; 'xla' by default, as the
    JAX receiver's) bit for bit. ``convert.pipeline_from_jax`` carries a
    JAX pipeline's parameters and state over."""

    def __init__(self, cfg: AMConfig = AMConfig(), block_len: int = 1_000_000,
                 mesh=None, exact: bool = False, backend: str = "xla",
                 input_format: str = "c64"):
        if _rational(cfg.rate) is None:
            raise ValueError("pipelined receiver needs a rational rate")
        if input_format not in INPUT_FORMATS:
            raise ValueError(f"unknown input_format {input_format!r} "
                             "(use 'c64', 'i16' or 'u8')")
        self.cfg = cfg
        self.block_len = int(block_len)
        self.input_format = input_format
        self.exact = bool(exact)
        self.backend = _check_back_end(self.exact, backend)
        self.mesh = make_stage_mesh(mesh)
        d0, d1 = self.mesh
        p0, self._st0, self.n_out = build(cfg, self.block_len, input_format, device=d0)
        self.params = (p0, lanes.tree_map(lambda v: v.to(d1), p0))
        self.stages = tuple(_Stage(d, self._stream(d)) for d in self.mesh)
        self.reset()

    def _stream(self, device):
        """A stream of this receiver's own on a card (None on the CPU),
        handed back to the pool when the receiver goes."""
        if device.type != "cuda":
            return None
        from ..io.stream import _live, _own_stream
        s = _own_stream(device)
        weakref.finalize(self, _live.discard, (device, s.cuda_stream))
        return s

    @property
    def device(self) -> torch.device:
        """Stage 0's device, where a block is taken."""
        return self.mesh[0]

    def reset(self):
        """Fresh stage state for a new stream."""
        d1 = self.mesh[1]
        st0 = self._st0
        self.state = AMPipeState(
            rs_tail=st0.rs_tail.clone(),
            agc=lanes.tree_map(lambda v: v.to(d1), st0.agc),
            am=lanes.tree_map(lambda v: v.to(d1), st0.am),
            deemph=st0.deemph.to(d1),
            buf=torch.zeros(self.n_out, dtype=torch.complex64, device=d1))
        self._fed = 0

    def _input(self, iq):
        iq = torch.as_tensor(iq)
        if self.input_format in ("i16", "u8"):
            want = torch.int16 if self.input_format == "i16" else torch.uint8
            if iq.dtype != want or iq.ndim != 2 or iq.shape[1] != 2:
                raise TypeError(
                    f"input_format={self.input_format!r} expects (N, 2) "
                    f"{want} [re, im]; got {iq.dtype} {tuple(iq.shape)}")
        else:
            iq = iq.to(torch.complex64)
            if iq.ndim != 1:
                raise TypeError(f"input_format='c64' expects (N,) complex; "
                                f"got shape {tuple(iq.shape)}")
        if iq.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} samples")
        s0 = self.stages[0]
        iq = iq.to(s0.device).contiguous()
        if s0.stream is not None:
            # the block comes from the caller's stream
            s0.stream.wait_stream(torch.cuda.current_stream(s0.device))
            iq.record_stream(s0.stream)
        return iq

    def _step(self, iq, valid: bool):
        self.state, pcm = pipeline_step(self.params, self.state, iq, valid, cfg=self.cfg,
                                        exact=self.exact, backend=self.backend,
                                        n_out=self.n_out, stages=self.stages)
        s1 = self.stages[1]
        if pcm is not None and s1.stream is not None:
            # the caller reads the pcm on its stream
            cur = torch.cuda.current_stream(s1.device)
            cur.wait_stream(s1.stream)
            pcm.record_stream(cur)
        return pcm

    def __call__(self, iq):
        iq = self._input(iq)
        with torch.profiler.record_function("PipelinedAMReceiver.step"):
            pcm = self._step(iq, self._fed >= 1)
        self._fed += 1
        return pcm if self._fed >= 2 else None   # the fill bubble

    def flush(self):
        """Drain the block in flight and END the stream: the drain feeds
        zeros through the front end, so the carried state afterwards is
        the zero feed's, not the stream's. The receiver therefore resets
        itself; start the next stream with plain calls."""
        if self._fed == 0:
            return None
        d0 = self.mesh[0]
        if self.input_format == "i16":
            zeros = torch.zeros((self.block_len, 2), dtype=torch.int16, device=d0)
        elif self.input_format == "u8":
            # 127 ~ zero signal to within half an LSB
            zeros = torch.full((self.block_len, 2), 127, dtype=torch.uint8, device=d0)
        else:
            zeros = torch.zeros((self.block_len,), dtype=torch.complex64, device=d0)
        pcm = self._step(self._input(zeros), True)
        self.reset()
        return pcm
