"""The 1024-channel channelized demod bank (BASELINE config 4):
``tpudsp_torch.chains.channelizer.ChannelizedBank`` called on each block
(``bank_step``: csrc/pfb_branch.cu, the IFFT, then the FM discriminator
and the column de-emphasis, or the coherent AM back end on csrc/
am_front_scan.cu and csrc/first_order_scan.cu).

What the band carries is the traffic: the mix's ``signal`` ('fm' or 'am')
picks the demodulator, and the configuration's ``am_coherent`` says how AM
is received. The judged pair is held against ``reference.bank`` run from
zero over ``judge_prefix_s`` seconds of the stream before it and over the
pair: the branch sum and the IFFT, the discriminator or the coherent back
end, and the de-emphasis, on every channel and across the pair's block
boundary. The number compared is the worst channel's.
"""

from __future__ import annotations

import math

import numpy as np

from bench_gpu import signals
from bench_gpu.reference import bank
from bench_gpu.reference.precision import F64


def bank_config(cfg: dict, mix: dict):
    from tpudsp_torch.chains.channelizer import ChannelizedBankConfig, ChannelizerConfig
    b = {k: v for k, v in cfg["bank"].items()}
    return ChannelizedBankConfig(channelizer=ChannelizerConfig(**cfg["channelizer"]),
                                 demod=mix["signal"], **b)


def reference_config(cfg: dict, mix: dict) -> dict:
    return {"channelizer": cfg["channelizer"], "bank": dict(cfg["bank"], demod=mix["signal"])}


class Program:
    def __init__(self, bank_, cfg, mix, prefix_blocks: int):
        self.bank = self.target = bank_
        self.prefix_blocks = prefix_blocks
        C = cfg["channelizer"]["nchan"]
        T = cfg["channelizer"]["taps_per_branch"]
        self.shapes = dict(C=C, T=T, N=int(mix["block_len"]),
                           wire_bytes=4 if mix["format"] == "i16" else 8,
                           coherent=mix["signal"] == "am" and cfg["bank"]["am_coherent"])

    def __call__(self, block):
        return self.bank(block)

    def work(self) -> dict:
        """What the hand kernels compute a block, for their rooflines."""
        s = self.shapes
        w = {"pfb_branch": {"C": s["C"], "T": s["T"], "N": s["N"],
                            "wire_bytes": s["wire_bytes"]}}
        if s["coherent"]:
            w["am_front_scan"] = {"samples": s["N"]}
        return w


def prefix_frames(cfg: dict, params: dict) -> int:
    ch = cfg["channelizer"]
    return math.ceil(params["judge_prefix_s"] * ch["iq_rate"] / ch["nchan"])


def build(cfg: dict, params: dict, mix: dict, device):
    from tpudsp_torch.chains.channelizer import ChannelizedBank
    bk = ChannelizedBank(bank_config(cfg, mix), int(mix["block_len"]), backend=cfg["backend"],
                         input_format=mix["format"], device=device)
    n = int(mix["block_len"])
    need = prefix_frames(cfg, params) * cfg["channelizer"]["nchan"]
    return Program(bk, cfg, mix, -(-need // n))



def reference(cfg, params, mix, ring, g0, device, prec=F64):
    """The reference's audio (C, frames) of blocks g0 and g0 + 1."""
    C = cfg["channelizer"]["nchan"]
    P = prefix_frames(cfg, params)
    x = signals.segment(ring, g0, P * C)
    audio = bank.bank_f64(x, reference_config(cfg, mix), device, prec)
    return audio[:, P:]


def compare(ref, got, params) -> list:
    """worst_ch_err_db: the largest over the channels of the error's power
    over the reference's over the pair, in dB."""
    got = np.asarray(got, np.float64)
    lim = params["limit_worst_ch_err_db"]
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return [{"name": "worst_ch_err_db", "value": float("inf"), "limit": lim, "ok": False,
                 "why": f"output shape {got.shape} (want {ref.shape}) or not finite"}]
    e = np.sum((got - ref) ** 2, axis=1) / np.sum(ref ** 2, axis=1)
    worst = float(10.0 * np.log10(np.max(e) + 1e-300))
    return [{"name": "worst_ch_err_db", "value": worst, "limit": lim, "ok": worst <= lim}]


def judge(cfg, params, mix, ring, g0, outs, device) -> list:
    got = np.concatenate([o.numpy() for o in outs], axis=1)
    return compare(reference(cfg, params, mix, ring, g0, device), got, params)
