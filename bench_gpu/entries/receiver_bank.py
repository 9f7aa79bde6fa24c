"""The 16-channel receiver bank (BASELINE config 3):
``tpudsp_torch.chains.bank.ReceiverBank`` called on each block
(``bank_step``: csrc/halo_async.cu's channel filter over the shared
stream, the phase lattice's rotation, then the discriminator, the audio
decimator and one csrc/first_order_scan.cu launch of de-emphasis).

What the channels carry is the traffic: the mix's ``signal`` picks the
demodulator. The judged pair is held against ``reference.receiver_bank``
run from zero over ``judge_prefix_s`` seconds of the stream before it and
over the pair: the mix-down and channel filter, the discriminator, the
audio decimator and the de-emphasis, on every channel and across the
pair's block boundary. The number compared is the worst channel's, as in
the channelized bank's entry.
"""

from __future__ import annotations

import numpy as np

from bench_gpu import registry, signals
from bench_gpu.reference import receiver_bank
from bench_gpu.reference.precision import F64

compare = registry.entry("channelized_bank").compare


def reference_config(cfg: dict, mix: dict) -> dict:
    return dict(cfg["bank"], demod=mix["signal"])


def prefix_samples(cfg: dict, params: dict) -> int:
    """The judged prefix in stream samples, whole audio samples."""
    b = cfg["bank"]
    D = b["decim1"] * b["decim2"]
    return -(-round(params["judge_prefix_s"] * b["iq_rate"]) // D) * D


class Program:
    def __init__(self, bank_, cfg, mix, prefix_blocks: int):
        self.bank = self.target = bank_
        self.prefix_blocks = prefix_blocks
        b = cfg["bank"]
        N = int(mix["block_len"])
        self.shapes = dict(C=len(b["freqs"]), taps=b["taps1"], N=N, nj=N // b["decim1"],
                           wire_bytes=4 if mix["format"] == "i16" else 8)

    def __call__(self, block):
        return self.bank(block)

    def work(self) -> dict:
        """What the hand kernels compute a block, for their rooflines."""
        return {"halo_async": dict(self.shapes)}


def build(cfg: dict, params: dict, mix: dict, device):
    from tpudsp_torch.chains.bank import BankConfig, ReceiverBank
    b = cfg["bank"]
    bc = BankConfig(freqs=tuple(b["freqs"]), iq_rate=b["iq_rate"], demod=mix["signal"],
                    decim1=b["decim1"], decim2=b["decim2"], kd=b["kd"], taps1=b["taps1"],
                    taps2=b["taps2"])
    n = int(mix["block_len"])
    rx = ReceiverBank(bc, n, backend=cfg["backend"], input_format=mix["format"],
                      device=device)
    return Program(rx, cfg, mix, -(-prefix_samples(cfg, params) // n))


def reference(cfg, params, mix, ring, g0, device, prec=F64):
    """The reference's audio (C, pcm) of blocks g0 and g0 + 1."""
    b = cfg["bank"]
    P = prefix_samples(cfg, params)
    x = signals.segment(ring, g0, P)
    audio = receiver_bank.receiver_bank_f64(x, reference_config(cfg, mix), device, prec)
    return audio[:, P // (b["decim1"] * b["decim2"]):]


def judge(cfg, params, mix, ring, g0, outs, device) -> list:
    got = np.concatenate([o.numpy() for o in outs], axis=1)
    return compare(reference(cfg, params, mix, ring, g0, device), got, params)
