"""The AM receiver (BASELINE config 1): ``tpudsp_torch.chains.am.AMReceiver``
called on each block, its ``forward`` (``am_step_fused`` with the fused
back end: the front-end matmul, csrc/am_front_scan.cu, csrc/
first_order_scan.cu's linear tail).

The judged pair is held against ``reference.am_chain`` run from zero over
the stream before it (``judge_prefix_s`` seconds of radio, so that the
AGC, the carrier PLL, the DC tracker and the de-emphasis have forgotten
their start) and over the pair: the fused front end, the resampling, the
AGC / PLL scan, the DC tracker and the de-emphasis, across the pair's
block boundary.
"""

from __future__ import annotations

import math

import numpy as np

from bench_gpu import signals
from bench_gpu.reference import am_chain
from bench_gpu.reference.precision import F64


class Program:
    def __init__(self, rx, prefix_blocks: int):
        self.rx = self.target = rx
        self.prefix_blocks = prefix_blocks

    def __call__(self, block):
        return self.rx(block)

    def work(self) -> dict:
        """What the hand kernels compute a block, for their rooflines."""
        return {"am_front_scan": {"samples": self.rx.n_out}}


def prefix_samples(cfg: dict, params: dict) -> int:
    """The reference's run-in before the pair: judge_prefix_s of radio,
    rounded up to whole Q-sample groups so the resampler's phase holds."""
    _, Q = am_chain.rate_pq(cfg["am"])
    n = math.ceil(params["judge_prefix_s"] * cfg["am"]["iq_rate"])
    return -(-n // Q) * Q


def build(cfg: dict, params: dict, mix: dict, device):
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    rx = AMReceiver(AMConfig(**cfg["am"]), int(mix["block_len"]), mix["format"],
                    plan=cfg["receiver"]["plan"], exact=cfg["receiver"]["exact"],
                    backend=cfg["receiver"]["backend"], device=device)
    n = int(mix["block_len"])
    return Program(rx, -(-prefix_samples(cfg, params) // n))



def reference(cfg, params, mix, ring, g0, device, prec=F64):
    """The reference's pcm of blocks g0 and g0 + 1 (concatenated)."""
    n_prefix = prefix_samples(cfg, params)
    pcm = am_chain.am_chain_f64(signals.segment(ring, g0, n_prefix), cfg["am"], prec)
    P, Q = am_chain.rate_pq(cfg["am"])
    return pcm[n_prefix * P // Q:]


def compare(ref, got, params) -> list:
    """err_db: the error's power over the reference's over the pair, in dB."""
    got = np.asarray(got, np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return [{"name": "err_db", "value": float("inf"), "limit": params["limit_err_db"],
                 "ok": False, "why": f"output shape {got.shape} (want {ref.shape}) or not finite"}]
    err = float(10.0 * np.log10(np.sum((got - ref) ** 2) / np.sum(ref ** 2) + 1e-300))
    return [{"name": "err_db", "value": err, "limit": params["limit_err_db"],
             "ok": err <= params["limit_err_db"]}]


def judge(cfg, params, mix, ring, g0, outs, device) -> list:
    got = np.concatenate([o.numpy() for o in outs])
    return compare(reference(cfg, params, mix, ring, g0, device), got, params)
