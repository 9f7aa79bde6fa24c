#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpudsp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit. ``--parent DIR`` names a checkout of an earlier commit (its
files unpacked, e.g. by ``git archive``): the run then also holds pll_scan
bit for bit against DIR's kernel, built from DIR's source, times DIR's
pfb_branch and rows launch beside this tree's, and, in a second process
with DIR's package, times one AM block, counts its launches and times
first_order_scan's, halo_async's and biquad_scan's calls
(``--profile-root DIR`` alone prints that report and exits) and the config
4 paths' blocks (``--channelizer-root DIR``). Phases,
each of which fails the run (exit code 1, no final result line) if it
fails:

1. build   -- compile every kernel of the port from csrc/ with nvcc, one
              process per source, all at once, print the seconds it took
              and ptxas's registers, shared memory and spills of each;
2. kernel  -- each CUDA kernel against its plain PyTorch version on the
              card, at the shapes its paths give it and at the shapes
              where the kernels' bookkeeping could go wrong:
              am_front_scan: the AM receiver's shape (one stream, 96000
                samples, chunk = warmup = 3840: 25 lanes), a ragged
                3-stream batch with squelch on, the same batch at chunk
                1000 and warmup 2500 (a chunk the stage depth does not
                divide, stages crossing chunk boundaries in the warmup,
                150 lanes) and at chunk 50 (shorter than a stage), a short
                block and the exact single-lane launch at the AMRadio
                callback's length, the sharded receiver's 3840-sample
                entry scan from a carried state, and PLL states and a loop
                gain that take the PLL warp's unbounded instance (theta
                outside [-pi, pi], the wrap's fmodf path); its matrix
                instance (front_chunked_mc: the channelizer's (M, C) matrix
                read in place, the rows written) bit for bit against the
                planes launch at the coherent channelized bank's shape
                (1024 x 16384, chunk = warmup = 3840: 5 chunks, the last
                padded by 2816, and the exact re-run of the tail) and at
                1000 channels with PLL states that take the unbounded
                instance, and against its plain version at 40 channels;
                the rows linear tail (one linear_tail_scan launch over
                1024 rows of 16384) against the DC tracker's row scan, the
                eager audio line and the de-emphasis row scan it replaced
                (>= 120 dB; bit-equality logged); the coherent bank's
                launches a block (cam's backend 'xla': 2 of the matrix
                instance, 1 rows tail); both timed against the forms they
                replaced in phase 10;
              agc_scan: one 4,000,000-sample block on the Pallas route
                (chunk 1024, warmup 3840: 3907 lanes, ragged last chunk),
                the same block on the XLA route (chunk = warmup = 3840), a
                ragged 3-stream batch with squelch on on the Pallas route
                (also at chunk 1000, warmup 3750, and at chunk 50) and the
                XLA route, and
                the exact single-lane launch at the README AMRadio's
                callback shape;
              pll_scan: the chunked scan over 96,000 samples, the exact
                single-lane launch at the AMRadio's callback shape, a
                ragged 3-stream batch at its default chunk and at chunk 50,
                and states that take the unbounded instance (theta = 20,
                freq = -9), chunked and exact;
              first_order_scan: one recurrence with the DC tracker's and
                the de-emphasis's coefficients at 96,000 samples, ragged
                lengths 12,345, 7 and 32, 3 rows with distinct carries,
                two chained calls, the carry scan's tile edges (8191, 8192,
                8193 and 16389 samples, also 3 rows), and linear_tail_scan
                (the AM receiver's whole tail) at 96,000 samples with and
                without DC tracking and at 16389;
              first_order_scan_c64 (first_order_scan over a complex64
                row's re and im parts as two rows): FMStereo's
                pilot smoother (rho = 0.999) at 2^18 samples, lengths 7,
                32, 33 and the tile edges, two chained calls, and against
                float64 (>= 130 dB);
              biquad_scan: CLowpassIIR(order=8, Fc=0.0075, mode="scan")'s
                cascade on 2^18 complex64 samples, the cheby2 order-8
                config and BroadcastAM's DC block at 1 and 7 samples and
                at biquad_scan's own edges (kernels/iir's SOS_L-sample
                block, SOS_TILE-sample tile and SOS_WINDOW-tile fold
                window: L - 1, L, L + 1, T - 1, T, T + 1, 2T + 5, WT - 1,
                WT, WT + 1, 2WT + 5) from random carried states (complex
                and real rows), three chained calls across a window, and
                both designs against float64 at 65,536 samples (>= 120 dB);
              the stream's shared scratch: three rounds of biquad_scan
                (over two fold windows), the complex64 call, real rows and
                linear_tail_scan (over four of their tiles) back to back
                from denormal states, bit for bit, every flag slot holding
                0 or an epoch used on the stream;
              halo_async: the async-halo front end on a 1x1 mesh at the AM
                shape (a 4M-sample c64 shard, the AM design's 3 phases of
                24 x 125 offset-folded real taps, also with an nj that 8
                does not divide) and at the bank shape (16 channels of 128
                taps decimating by 10, 4M samples of c64, int16 and uint8,
                and a 1970-sample uint8 shard whose two launches are each
                shorter than a tile), each with a random carried tail;
              bank_rotate: the receiver bank's rotation and discriminator
                at bank16's (16, 800000), at 17 channels, at 1, 511, 512,
                513 and 1025 outputs (its 512-output chunk's edges),
                across the 2^32 wrap, with zero, infinite and NaN samples
                and over three chained calls.
              am_front_scan, agc_scan, first_order_scan (rows and complex),
              biquad_scan and bank_rotate must equal their plain versions bit
              for bit
              (outputs, modes and final states); pll_scan must reach 90 dB SNR with close final
              states (and equal, with --parent, the parent's kernel bit for
              bit); halo_async must reach 110 dB (it sums in another order
              than cuBLAS);
3. chain   -- AMReceiver on the card over two 2M-sample blocks against the
              float64 sample-serial oracle chain (numpy, on the host):
              >= 100 dB over the settled second half;
4. width   -- the AM receiver at full width: AMReceiver on 4M-sample blocks
              (the largest block of the JAX package's bench), three blocks
              with carried state, for c64, i16 and u8 input; i16/u8 >= 90 dB
              against c64, all finite, am_front_scan launched (launch counts
              are zeroed just before and read just after this path);
5. sharded -- ShardedAMReceiver on a 1x1 mesh at full width: three
              4M-sample c64 blocks with halo='async' and with
              halo='ppermute'; async against ppermute, each against
              AMReceiver on the same blocks and async against the float64
              oracle chain (past the first block), all >= 100 dB;
              halo_async launched during the async run;
6. compat  -- the README's AMRadio, verbatim, on tpudsp_torch.compat on the
              card: 2 Msps int16 bytes through bytes_to_iq, 2^21 samples in
              2^18-sample callbacks, >= 100 dB over the settled half against
              a float64 oracle chain built from the compat ops' own designs;
              agc_scan and pll_scan launched during this path. Then
              AGC(throughput_mode=True, use_pallas=True) over three
              4M-sample blocks with carried state: finite, agc_scan launched;
7. options -- AMReceiver with exact=True (backend='xla'), backend='xla'
              and plan='composed' on 4M-sample c64 blocks: each >= 100 dB
              against the float64 oracle chain past the first block,
              composed against fused >= 70 dB, the XLA back end against the
              fused-kernel back end >= 65 dB, each path's launches of every
              kernel, each path's block time (median of 5, spread);
8. surface -- every class beyond the AMRadio's, built with no device (so
              on the card) at its users' sizes: CLowpassIIR(order=8,
              Fc=0.0075, mode="scan") on 2^18-sample c64 callbacks,
              BroadcastAM on 6291-sample blocks, FMStereo(600000, 48000) on
              2^18-sample composite blocks, NCO, FreqDem, SSBDemod, Delay
              and HilbertTransform on 2^18 samples; each against its
              float64 oracle on a prefix of <= 65,536 samples (tests/
              oracle/, or the reference topology written out in float64
              where the oracle's own module imports the JAX package) at
              FIDELITY.md section 1's bars, each path's launches, each
              call timed (median of 5, spread);
9. receivers -- the other chains at bench.py's widths (configs 2 and 3):
              the 16-channel FM bank (linspace(-1e6, 1e6, 16), 2.4 Msps)
              on three 8M-sample blocks in c64, i16 and u8 (and c64 of the
              i16 / u8 values), a mixed fm / coherent am / usb / lsb bank
              over the same channels, WBFM mono and stereo (c64 / i16 /
              u8) on 2M-sample blocks, SSBReceiver on 1M-sample blocks,
              chunked and exact. Each path's first kernel calls are
              recorded and held against their plain versions on the same
              tensors (halo_async, the bank's front end on one card, on
              blocks 0 and 1, whose halo is block 0's tail, against
              cfir_ref and the conv form at 110 dB; bank_rotate,
              am_front_scan, agc_scan, first_order_scan's rows and the
              pilot smoothers bit for bit); the FM channels against the
              float64 FM-bank oracle (tests/oracle/bank_oracle.py, >= 100
              dB), i16 / u8 against the c64 of their values (90; u8 60
              then 85), stereo separation and SSB sideband rejection (> 30
              dB), two blocks against one of double length (> 60 dB);
              bank16's kernels a block in a profiler window opened by one
              block (BANK16_LAUNCHES), its cfir_kernel and
              bank_rotate_kernel once a block as their counters say; each
              path's block time, samples/s and a profiler window, the bank
              front at bank16's shape (the kernel, conv1d and the wide
              matmul), and bank_rotate there against its bound and the
              eager form it replaced;
10. channelizer -- BASELINE config 4 at full width (bench.py:506-539):
              ChannelizedBankConfig(), 1024 channels of 12 taps a branch at
              100 Msps, blocks of 1024 x 16384 samples. pfb_branch bit for
              bit against its plain version (kernels/pfb) at the block's
              shape in c64 / i16 / u8, os 1 and 2, at T = 12, 8 and 6, at
              one frame, around the carried tail's length, at 100 frames
              and behind the first block's tail, and T = 17 refused; the
              column carry (one first_order_scan_cols launch) bit for bit
              against kernels/iir.first_order_apply_blocked_mc at (16384,
              1024), at 1 ... 16385 frames (its 1024-frame tile's edges),
              at 1022 and 1021 channels, with infinite and NaN samples and
              over two chained calls; the FM bank's fused launch (one
              fm_deemph_cols launch: the discriminator and the column
              carry from the complex64 channel matrix) bit for bit
              against kernels/iir.fm_deemph_cols at (16384, 1024), at 1
              ... 16385 frames, at 1022 and 1021 channels, with zero,
              infinite and NaN frames and over three chained calls.
              Paths, each with its
              launches a block: the FM bank in c64 / i16 / u8 (and the c64
              of the i16 / u8 values) on three blocks, os = 2 and the 'conv'
              engine, envelope AM, coherent AM on all 1024 channels and a
              mixed fm / coherent am bank (backend 'kernel', the coherent
              launch bit for bit against its plain version:
              front_chunked_mc_ref, front_chunked_ref). Y of the 16
              carriers' channels against the float64 oracle
              (tests/oracle/bank_oracle.channelizer_f64, >= 120 dB), the FM
              audio against its discriminator and de-emphasis (>= 100),
              i16 / u8 against c64 (>= 90), 'conv' against 'shift' (>=
              110), the AM carriers DC-free and on their tones, the mixed
              bank's FM rows against the FM bank's (>= 100); each path's
              block time, pfb_branch's call, launch alone and device time
              in c64 / i16 / u8, os 1 and 2, against its bound (c64 also
              against conv1d), the column carry's call and device time
              against its bound and the parent's form (the transpose and a
              rows launch); with --parent, the parent's pfb_branch and
              rows launch built and swapped in, in turns with this tree's,
              and each path's block time beside the parent package's (in
              a process of its own, --channelizer-root);
11. parallel -- the rest of the sharded runtime on the card through its
              entry points, on one-rank meshes (NCCL refuses two ranks on
              one card; chip_sharded.py runs the rings): ShardedBank on a
              (1, 1) mesh, bank16 on three 8M-sample blocks in c64 / i16 /
              u8 with halo='ppermute' and c64 with halo='async', and the
              mixed fm / coherent am / usb / lsb bank, against the
              single-card ReceiverBank (the mixed one with backend 'xla')
              on the same blocks; ShardedChannelizer and
              ShardedChannelizedBank at config 4's width with c1 = 32 (the
              twiddle and both transform stages run) and c1 = None: Y of
              the 16 carriers' channels against Channelizer (>= 120 dB),
              the FM bank in c64 / i16 / u8 and the coherent AM bank
              against ChannelizedBank (>= 100 dB on the carriers);
              ShardedScanner (config 5's one-chip core, bench.py:541-547)
              FM c64 / u8 and coherent AM against ChannelizedBank (>= 100
              dB); PipelinedAMReceiver with both stages on the card, each
              on its own stream, four 4M-sample blocks and the flush in
              c64 / i16 / u8, bit for bit against AMReceiver(backend=
              'xla'); ElasticRunner over AMReceiver on 4M-sample blocks,
              snapshot_every=2, a chain that raises once at block 3: the
              resumed and replayed pcm bit for bit against an
              uninterrupted run. Each comparison is bit for bit or prints
              its SNR and max abs difference (the sharded bank >= 120
              dB); each path's launches a block; the bank, the split
              channelized bank, the scanner and the pipeline timed (host
              clock median of 5 with spread, CUDA events) beside their
              single-card chains;
12. stream -- the io runtime (tpudsp_torch.io) driving the chains on the
              card from raw radio bytes: StreamRuntime over AMReceiver
              (config 1, 4M-sample blocks) in int16_raw / i16, uint8_raw /
              u8 and int16 / c64, four blocks pushed in 2^18-sample chunks;
              bank16 (config 3, u8, 8M-sample blocks) fed by RadioSource
              from MockRTLSDRDriver, three blocks, each channel on its
              tone, and a burst into a one-block ring whose drops are whole
              chunks, counted alike by the source and the ring; config 4
              (u8, 1024 x 16384-sample blocks, a ring of 4) pushed at the
              radio's 200 MB/s for 8 blocks (3 distinct), no byte dropped;
              every runtime's audio bit for bit against serial calls of a
              fresh receiver on the same blocks, and its launches a block
              as serial; the AM i16 and bank16 runtimes pumping at once
              from two producer threads, each bit-equal; on_audio on the
              card (a WavSink and per-block metric reads) giving the file
              write_wav makes of the serial pcm; after stop(), the
              receiver's state saved and loaded into a fresh receiver,
              whose next block equals the original's; each cell's samples/s
              from the first push to the last audio beside the serial
              loop's and the card's busy share over that window; every
              examples_torch/*.py run once, exit code 0, its seconds;
13. timing -- per-format block time of the AM receiver (host clock and CUDA
              events), per-mode block time of the sharded receiver,
              per-callback time of the AMRadio (median of 5 with spread),
              one torch.profiler window over a c64 block (kernel launches
              and the device's busy share), and each kernel's time against
              its plain version's at its main shape, with the scans' ns per
              dependent step, the two staged kernels' launches alone and
              the sharded receiver's entry scan; first_order_scan's and
              halo_async's wrapper calls at their shapes and halo_async's
              launches alone (also for --parent's package), and
              halo_async's against one torch.nn.functional.conv1d call,
              TF32 off; biquad_scan's call at its main shape and at
              BroadcastAM's DC block (6291 real samples, 2 sections), each
              with its bound (also for --parent's package).

Phases 3-12 also count the kernels' launches on their path (the counts set
to 0 just before it, read just after) and fail on another count:
first_order_scan once per AMReceiver block, twice per ShardedAMReceiver
block (the DC tracker's rows and the de-emphasis) and per AMRadio callback
(AmpModem's DC tracker and DeemphasisFilter); in phases 7-9 every
kernel, per block or call (AM_OPTIONS, phase_surface, the receivers'
per-block counts: bank halo_async 1 and first_order_scan 1, bank16 and
WBFM mono also bank_rotate 1, the mixed bank am_front_scan 2 and
first_order_scan 1 more, stereo
first_order_scan 1 and first_order_scan_c64 2, SSB agc_scan 2 chunked
and 1 exact; in phase 10 pfb_branch 1 a block but for the 'conv' engine,
the FM bank fm_deemph_cols 1, envelope AM first_order_scan 1,
coherent am_front_scan 1 (its matrix instance) and first_order_scan 1,
mixed am_front_scan 1 and first_order_scan 2; in phase 11
am_front_scan 1 and first_order_scan 1 a block for AM, halo_async 1,
bank_rotate 1 and first_order_scan 1 for bank16, pfb_branch 1 and fm_deemph_cols 1 for
config 4, all but the two runtimes at once; in phase 11 the sharded bank
halo_async 1 (2 with halo='async') and first_order_scan 1 a block, the
mixed one am_front_scan 2 (the chunked launch and the padded last
chunk's exact re-run) and first_order_scan 2, the split channelizer
pfb_branch 1, its FM bank fm_deemph_cols 1 and its coherent AM bank
am_front_scan 2 and first_order_scan 2, the scanner pfb_branch 1 and
first_order_scan 1 (FM) or am_front_scan 2 and first_order_scan 2 (AM),
the pipeline agc_scan 1, pll_scan 2 and first_order_scan 2 a back end).

Prints the card's name and power limit first, and again (with the torch,
CUDA and Python versions) just before a "kernels" JSON line, which comes
before the last (per kernel: launches on its path, max abs error against
its plain version, ms, plain ms, the bound computed from the shape, the
library call's time, null where no single PyTorch call computes the
function, and for the scans the steps per lane and ns per step at the
main shape), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without that line when no CUDA device is present or when it
is run outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
CHUNK = WARMUP = 3840       # the AM receiver's chunk and warmup (default AMConfig)
N_OUT_4M = 96_000           # pcm samples of one 4M-sample block
BLOCK_4M = 4_000_000
AGC_CHUNK, AGC_WARMUP = 1024, 3840   # AGC op's Pallas route at alpha = 0.01
CALLBACK = 1 << 18          # examples/am_radio.py's callback
N_RADIO = 1 << 21
N_CALLBACK_OUT = 6291       # AGC / AmpModem samples per AMRadio callback
HBM_BPS = 3.35e12           # H100 SXM: device memory rate
F32_FLOPS = 67e12           # H100 SXM: f32 rate outside the tensor cores
# f32 operations per sample of each scan step (a transcendental counts one)
OPS_AGC, OPS_PLL = 25, 20
# f32 operations per sample of one blocked first-order recurrence: the
# within-block sum's 32 multiplies and 32 adds
OPS_FIRST_ORDER = 64
# f32 operations per sample of the FM discriminator: the conjugate
# product's four multiplies and two adds, patan2's two abs, max, min,
# divide, square, five multiply-adds of its Horner sum, product and three
# octant fixes, and the divide by 2 pi kd
OPS_FM_DISCRIMINATOR = 27
# f32 operations per output of the receiver bank's rotation before its
# discriminator: the angle's conversion and scale, its sine and cosine,
# and the rotation's four multiplies and two adds
OPS_BANK_ROTATION = 10
TILE_FO = 256 * 32          # samples of one tile of first_order_scan's carry scan
# f32 operations per sample, row and section that the SOS cascade needs:
# one double-float step (125 as biquad_scan.cu writes it, 101 with the
# splits of the constant coefficients made on the host and those of x and
# v0.hi made once) and the output (3); the kernel's scan and the products
# that give each sample's state from its block's entry are its
# algorithm's cost, not the function's
OPS_BIQUAD = 104
N_SURFACE = 1 << 18         # the classes' block: the README's callback
N_ORACLE = 65_536           # the prefix held against the float64 oracles
DC_RHO = 0.9995             # the AM receiver's DC tracker pole
PARENT: Path | None = None  # --parent: a checkout of an earlier commit

results: dict = {"kernels": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


def snr_db(ref, test) -> float:
    ref = np.asarray(ref)
    ref = ref.astype(np.complex128 if np.iscomplexobj(ref) else np.float64)
    err = ref - np.asarray(test, ref.dtype)
    p_err = np.mean(np.abs(err) ** 2)
    return float("inf") if p_err == 0 else float(10 * np.log10(np.mean(np.abs(ref) ** 2) / p_err))


def bound(name: str, nbytes: float, ops: float):
    """The least time for the work: bytes over the memory rate, operations
    over the f32 rate; record it and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / F32_FLOPS * 1e3
    results["kernels"][name].update(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations")


def am_signal(n: int, rate: float, carrier_hz: float, amp: float = 0.3,
              msg_hz: float = 1000.0, noise: float = 0.0, seed: int = 0):
    """AM test signal (complex64) at ``rate``, as tests/test_chain_snr.py
    makes it, with optional complex white noise from ``seed``."""
    t = np.arange(n)
    x = ((1.0 + 0.5 * np.sin(2 * np.pi * msg_hz / rate * t)) * amp
         * np.exp(2j * np.pi * carrier_hz / rate * t))
    if noise:
        rng = np.random.default_rng(seed)
        x = x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def oracle_chain(iq, sos, H, rate, agc_bw, agc_scale, modulation, pcm_rate):
    """The float64 sample-serial oracle chain of tests/test_chain_snr.py:
    bandpass (sos) -> resample (bank H) -> AGC -> PLL AM demod with DC
    tracker -> de-emphasis, from tests/oracle/liquid_oracle.py. The
    bandpass runs as scipy's sosfilt, the same transposed direct form II
    recurrence as its SosFilterOracle, in float64."""
    import scipy.signal as sig
    from tpudsp_torch.design import iirdes
    lo = oracle_module("liquid_oracle")
    bb = sig.sosfilt(sos, np.asarray(iq, np.complex128))
    agc = lo.AgcOracle(bandwidth=agc_bw)
    agc.scale = agc_scale
    agc.sq_mode = 7  # squelch disabled
    y, _ = agc(lo.ResampOracle(H, rate, complex_data=True)(bb))
    theta, freq, dc = 0.0, 0.0, 0.0
    alpha, beta, rho = 0.001, np.sqrt(0.001), 0.9995
    out = np.empty(len(y))
    for n in range(len(y)):
        v = y[n] * np.exp(-1j * theta)
        err = np.angle(v) if abs(v) > 0 else 0.0
        freq += alpha * err
        theta = (theta + beta * err + freq + np.pi) % (2 * np.pi) - np.pi
        dc = rho * dc + (1 - rho) * v.real
        out[n] = (v.real - dc) / modulation
    return lo.FirstOrderOracle(*iirdes.deemphasis_coeffs(pcm_rate))(out)


def oracle_am_chain(iq, cfg):
    """The oracle chain with AMReceiver's designs."""
    from tpudsp_torch.design import firdes, iirdes
    sos = iirdes.iirdes_sos("cheby2", "lowpass", cfg.order,
                            cfg.bandwidth / cfg.iq_rate, As=60.0, Ap=0.5)
    H = firdes.resamp_bank(cfg.resamp_m, 0.45 * cfg.rate, 60.0, cfg.resamp_npfb)
    return oracle_chain(iq, sos, H, cfg.rate, cfg.agc_bandwidth, cfg.agc_scale,
                        cfg.modulation, cfg.pcm_rate)


def front_params(squelch=False, threshold=0.0):
    import torch
    from tpudsp_torch.kernels import agc as kagc
    from tpudsp_torch.kernels import am_backend as kab
    agcp = kagc.make_params(alpha=0.01, scale=0.01, squelch=squelch,
                            threshold=threshold, device=DEV)
    return kab.make_params(agcp, torch.tensor(0.5, device=DEV), 0.05, 0.95,
                           carrier=True)


def agc_state(C: int, squelch=False):
    from tpudsp_torch.kernels import agc as kagc
    return kagc.AgcState(*(v.expand(C).contiguous() for v in
                           kagc.agc_init(squelch=squelch, device=DEV)))


def front_state(C: int, squelch=False):
    import torch
    from tpudsp_torch.kernels import am_backend as kab
    z = lambda: torch.zeros(C, device=DEV)
    return kab.FrontState(agc_state(C, squelch), kab.PllState(z(), z()))


def timed(fn):
    """(fn(), its time in ms on the card's clock)."""
    import torch
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_ms(fn, part: str, reps: int) -> float:
    """Mean device time (ms) of the kernels whose name holds ``part``,
    over ``reps`` calls of fn after a warm-up call, by torch.profiler: the
    kernel alone, where a CUDA-event time of a short call is the host's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ts = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and part in e.name]
    return sum(ts) / len(ts) / 1e3 if ts else float("nan")


# --------------------------------------------------------------------------
def phase_build():
    from tpudsp_torch.cuda import build
    # scan_step.cuh's sin_cos_reduced copies libdevice's sincosf: a toolkit
    # whose sincosf differs shows in the bit-equality checks of phase kernel
    ver = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True)
    log(f"build: nvcc {' '.join(ver.stdout.split()[-6:]) or ver.stderr.strip()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SIGNATURES)) as ex:
        libs = list(ex.map(build.compile_source, build.SIGNATURES))
    for name in build.SIGNATURES:
        build.load(name)
    log(f"build: {len(libs)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    # registers, shared memory and spills of every kernel
    for name in build.SIGNATURES:
        report = build.ptxas_report_path(name)
        lines = report.read_text().splitlines() if report.exists() else ["no report"]
        for line in lines:
            if line.strip():
                log(f"build: ptxas {name}: {line.strip()}")


def _close_theta(name, kst, rst):
    """Final PLL states of kernel vs plain: theta (wrapped) < 1e-3 rad."""
    d = np.angle(np.exp(1j * (kst.theta.double().cpu().numpy()
                              - rst.theta.double().cpu().numpy())))
    if not float(np.max(np.abs(d), initial=0.0)) < 1e-3:
        raise AssertionError(f"kernel[{name}]: final states disagree")


def _bits_equal(a, b) -> bool:
    """Every leaf of two state tuples equal bit for bit (a complex leaf as
    its re and im)."""
    import torch
    bits = lambda t: (torch.view_as_real(t) if t.is_complex() else t).cpu().view(torch.int32)
    return all(torch.equal(bits(u), bits(v)) for u, v in zip(a, b))


def _compare(name, kernel_out, ref_out):
    """A staged scan kernel vs its plain version: output (vr of
    am_front_scan, y of agc_scan), modes and final states equal bit for
    bit; the output's SNR per stream is logged. Returns the max abs error
    of the output."""
    import torch
    (kf, (ky, km)), (rf, (ry, rm)) = kernel_out, ref_out
    torch.cuda.synchronize()
    ky, ry = ky.cpu().numpy(), ry.cpu().numpy()
    worst = min(snr_db(ry[c], ky[c]) for c in range(ry.shape[0]))
    max_err = float(np.max(np.abs(ky - ry)))
    modes_equal = torch.equal(km.cpu(), rm.cpu())
    leaves = lambda f: (f.agc + f.pll) if hasattr(f, "pll") else tuple(f)
    states_equal = _bits_equal(leaves(kf), leaves(rf))
    log(f"kernel[{name}]: snr {worst:.2f} dB, max_abs_err {max_err:.3e}, "
        f"modes equal {modes_equal}, final states bit-equal {states_equal}")
    if not (max_err == 0.0 and ky.shape == ry.shape and modes_equal and states_equal):
        raise AssertionError(f"kernel[{name}] is not bit-equal to its plain version")
    return max_err


def _compare_pll(name, kernel_out, ref_out, snr_bar=90.0):
    """pll_scan vs its plain version: e^{j theta} SNR per stream, close
    finals. Returns the max abs (wrapped) error of theta."""
    import torch
    (kf, kth), (rf, rth) = kernel_out, ref_out
    torch.cuda.synchronize()
    kth, rth = kth.double().cpu().numpy(), rth.double().cpu().numpy()
    worst = min(snr_db(np.exp(1j * rth[c]), np.exp(1j * kth[c]))
                for c in range(rth.shape[0]))
    max_err = float(np.max(np.abs(np.angle(np.exp(1j * (kth - rth))))))
    log(f"kernel[{name}]: e^(j theta) snr {worst:.2f} dB, max_abs_err {max_err:.3e}")
    if not worst >= snr_bar:
        raise AssertionError(f"kernel[{name}] disagrees with its plain version")
    _close_theta(name, kf, rf)
    return max_err


def _expect_launches(path: str, got: int, want: int):
    """first_order_scan's launches on a path: exactly ``want``."""
    log(f"{path}: first_order_scan launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{path}: first_order_scan launched {got} times, not {want}")


def _record(name, max_err, plain_ms, **kw):
    results["kernels"].setdefault(name, {}).update(
        max_abs_err=max_err, plain_ms=plain_ms, **kw)


def halo_am_case(seed: int):
    """halo_async's inputs at the AM shape: a 4M-sample c64 shard, a
    random carried tail and the AM design's offset-folded taps, real (Tim
    None, the kernel's real-tap instance), as ShardedAMReceiver(halo=
    'async') passes them."""
    import torch
    from tpudsp_torch.chains.am import AMConfig, build as am_build
    params, st, _ = am_build(AMConfig(), BLOCK_4M, device=DEV)
    rng = np.random.default_rng(seed)
    kf = st.rs_tail.shape[0]
    tail = (rng.standard_normal(kf) + 1j * rng.standard_normal(kf)) * 0.3
    x = am_signal(BLOCK_4M, 2e6, 200.0, noise=0.01, seed=seed)
    return (torch.from_numpy(x).to(DEV), torch.from_numpy(tail.astype(np.complex64)).to(DEV),
            params.taps_fused, None, 125, N_OUT_4M // 3)


def halo_bank_case(fmt: str, seed: int, n_samples: int = BLOCK_4M):
    """halo_async's inputs at the bank shape: 16 channels of 128 random
    complex taps decimating by 10 (the wire scale folded in), n_samples
    (4M) samples and a 127-sample carried tail of c64 or raw (n, 2) int16
    / uint8."""
    import torch
    from tpudsp_torch.kernels import decimate as kdec
    C, K1, D1 = 16, 128, 10
    rng = np.random.default_rng(seed)
    scale = {"c64": 1.0, "i16": 1 / 32767, "u8": 1 / 127.5}[fmt] / np.sqrt(K1)
    taps = (rng.standard_normal((C, K1)) + 1j * rng.standard_normal((C, K1))) * scale
    Tre, Tim = (torch.from_numpy(kdec.plan_phase_taps(t.astype(np.float32), D1)).to(DEV)
                for t in (taps.real, taps.imag))
    n = n_samples + K1 - 1
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.2
    if fmt == "i16":
        w = np.clip(np.round(np.stack([z.real, z.imag], 1) * 32767), -32767, 32767).astype(np.int16)
    elif fmt == "u8":
        w = np.clip(np.round(np.stack([z.real, z.imag], 1) * 127.5 + 127.5), 0, 255).astype(np.uint8)
    else:
        w = z.astype(np.complex64)
    w = torch.from_numpy(w).to(DEV)
    return w[K1 - 1:].contiguous(), w[:K1 - 1].contiguous(), Tre, Tim, D1, n_samples // D1


def _compare_halo(name, case, snr_bar=110.0):
    """halo_async vs its plain version on one case: SNR over all outputs.
    Returns (max abs error, the plain version's ms after a warm-up call,
    which leaves cuBLAS's set-up out)."""
    import torch
    from tpudsp_torch.cuda import halo_async
    from tpudsp_torch.parallel import make_mesh
    mesh = make_mesh(1, 1, DEV)
    y = halo_async.bank_front_async(*case, mesh)
    ref = halo_async.bank_front_async_ref(*case, mesh)
    _, plain_ms = timed(lambda: halo_async.bank_front_async_ref(*case, mesh))
    torch.cuda.synchronize()
    y, ref = y.cpu().numpy(), ref.cpu().numpy()
    s, max_err = snr_db(ref, y), float(np.max(np.abs(y - ref)))
    log(f"kernel[{name}]: snr {s:.2f} dB (bar {snr_bar:.0f}), max_abs_err {max_err:.3e}")
    if not (y.shape == ref.shape and s >= snr_bar):
        raise AssertionError(f"kernel[{name}] disagrees with its plain version")
    return max_err, plain_ms


def kernel_front():
    """am_front_scan's cases; returns its main input and the callback's."""
    import torch
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.kernels import am_backend as kab
    # am_front_scan at the AM receiver's shape: one stream of 96000
    # pcm-rate samples (a 4M block)
    x = torch.from_numpy(am_signal(N_OUT_4M, 48_000.0, 200.0, noise=0.003,
                                   seed=1)[None]).to(DEV)
    p, st = front_params(), front_state(1)
    ref, plain_ms = timed(lambda: scan.front_chunked_ref(p, st, x, CHUNK, WARMUP))
    _record("am_front_scan", _compare(
        "am_front_scan C=1 L=96000", scan.front_chunked(p, st, x, CHUNK, WARMUP),
        ref), plain_ms)
    xs = ragged_batch()
    p, st = front_params(squelch=True, threshold=-35.0), front_state(3, squelch=True)
    _compare("am_front_scan ragged C=3 squelch",
             scan.front_chunked(p, st, xs, CHUNK, WARMUP),
             scan.front_chunked_ref(p, st, xs, CHUNK, WARMUP))
    # the staging edges: a chunk (1000) that the stage depth does not
    # divide, a warmup of 2.5 chunks (stages cross chunk boundaries inside
    # the warmup and the warmup / chunk boundary), 150 lanes (groups span
    # two streams, the last group is partly idle), a ragged last chunk,
    # squelch on
    _compare("am_front_scan ragged C=3 squelch chunk=1000 warmup=2500",
             scan.front_chunked(p, st, xs, 1000, 2500),
             scan.front_chunked_ref(p, st, xs, 1000, 2500))
    # a chunk shorter than a stage: every stage crosses chunk boundaries
    _compare("am_front_scan ragged C=3 squelch chunk=50 warmup=1030",
             scan.front_chunked(p, st, xs, 50, 1030),
             scan.front_chunked_ref(p, st, xs, 50, 1030))
    # short block: L <= chunk + warmup runs the exact single-lane launch
    xb = x[:, :2000].contiguous()
    p, st = front_params(), front_state(1)
    _compare("am_front_scan short C=1 L=2000",
             scan.front_chunked(p, st, xb, CHUNK, WARMUP), kab.front_exact(p, st, xb))
    # the exact single-lane launch at the AMRadio callback's length, and the
    # sharded receiver's entry scan (parallel/bank.py: front_exact over the
    # left neighbour's last 3840 samples from the carried state, here a
    # settled one)
    xc = torch.from_numpy(am_signal(N_CALLBACK_OUT, 48_000.0, 200.0, noise=0.003,
                                    seed=5)[None]).to(DEV)
    _compare(f"am_front_scan exact C=1 L={N_CALLBACK_OUT}",
             scan.front_exact(p, st, xc), kab.front_exact(p, st, xc))
    carried, _ = kab.front_exact(p, st, x[:, :8000])
    halo = x[:, -WARMUP:].contiguous()
    _compare(f"am_front_scan entry scan C=1 L={WARMUP} carried state",
             scan.front_exact(p, carried, halo), kab.front_exact(p, carried, halo))
    # the PLL warp's unbounded instance (libdevice sincosf, the wrap with
    # its fmodf path), which the states above never reach: stream 1 starts
    # at theta = 20 (fmodf on its first step, bounded stages after it),
    # stream 2 at freq = -9 (every stage of its groups unbounded, the wrap's
    # argument often below -2 pi); stream 0 from rest shares a group with
    # stream 1; chunked and exact launches, and a loop gain of 0.05, whose
    # stages are never bounded
    p, st = front_params(), front_state(3)
    st = kab.FrontState(st.agc, unbounded_pll_state())
    xu = xs[:, :20_000].contiguous()
    _compare("am_front_scan unbounded PLL C=3 chunk=1000 warmup=2500",
             scan.front_chunked(p, st, xu, 1000, 2500),
             scan.front_chunked_ref(p, st, xu, 1000, 2500))
    _compare("am_front_scan unbounded PLL exact C=3 L=6291",
             scan.front_exact(p, st, xu[:, :N_CALLBACK_OUT]),
             kab.front_exact(p, st, xu[:, :N_CALLBACK_OUT]))
    pw = front_params()._replace(pll_alpha=torch.tensor(0.05, device=DEV),
                                 pll_beta=torch.tensor(0.2236068, device=DEV))
    _compare("am_front_scan PLL gain 0.05 C=3 chunk=1000 warmup=2500",
             scan.front_chunked(pw, st, xu, 1000, 2500),
             scan.front_chunked_ref(pw, st, xu, 1000, 2500))
    return x, xc


def kernel_front_mc():
    """am_front_scan's matrix instance (cuda/am_backend_scan.front_chunked_mc):
    bit for bit against the planes launch of the transpose at the coherent
    channelized bank's shape and at 1000 channels (some of whose PLL states
    take the unbounded instance), and against its plain version at 40
    channels; each call's launches of each instance. Then the rows linear
    tail against the parent's two row scans and eager line, and the
    coherent bank's launches a block. Leaves the cam-shape inputs for
    ``time_front_mc`` (the channelizer phase: its profiler windows come
    after the receivers phase's, which opens the process's first)."""
    import torch
    from tpudsp_torch.chains.channelizer import ChannelizedBankConfig, bank_build
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.cuda import first_order as fo
    from tpudsp_torch.kernels.pll import PllState
    cfg = ChannelizedBankConfig(demod="am", am_coherent=True)
    (_, _, _, amb, _), st0 = bank_build(cfg, device=DEV)
    chunk, warmup = cfg.plan.chunk["xla"], cfg.plan.warmup
    M, C = N_PFB // 1024, 1024
    g = torch.Generator(device=DEV).manual_seed(61)
    t = torch.arange(M, device=DEV, dtype=torch.float64)[:, None]
    f = (torch.rand(C, generator=g, device=DEV, dtype=torch.float64) - 0.5) * 4e-3
    fm = 5e-3 + torch.rand(C, generator=g, device=DEV, dtype=torch.float64) * 1.5e-2
    amp = 10 ** (-3 * torch.rand(C, generator=g, device=DEV, dtype=torch.float64))
    Y = (amp * (1 + 0.5 * torch.sin(2 * np.pi * fm * t)) * torch.exp(2j * np.pi * f * t)
         + 1e-3 * torch.randn(M, C, generator=g, device=DEV, dtype=torch.complex128))
    Y = Y.to(torch.complex64)
    settled = PllState(((torch.rand(C, generator=g, device=DEV) - 0.5) * 2 * np.pi).float(),
                       ((torch.rand(C, generator=g, device=DEV) - 0.5) * 1e-3).float())

    def held(name, st, Yk, ch, wu, per_call):
        before = (scan._launch.launches, scan._launch.matrix)
        got = scan.front_chunked_mc(amb, st, Yk, ch, wu)
        torch.cuda.synchronize()
        counts = (scan._launch.launches - before[0], scan._launch.matrix - before[1])
        log(f"kernel[{name}]: launches (all, matrix) {counts}, expected {per_call}")
        if counts != per_call:
            raise AssertionError(f"kernel[{name}]: launches {counts}, not {per_call}")
        return got

    for name, st in (("bank state", st0.front), ("settled PLL", st0.front._replace(pll=settled))):
        label = f"am_front_scan matrix C={C} L={M} chunk {chunk} warmup {warmup} {name}"
        got = held(label, st, Y, chunk, warmup, (2, 2))
        _compare(f"{label} vs the planes launch", got,
                 scan.front_chunked(amb, st, Y.T.contiguous(), chunk, warmup))
    # 1000 channels (the last group of each chunk partly idle): every 7th
    # stream from theta = 20 (fmodf on its first step), every 11th at freq
    # = -9 (its groups' stages unbounded)
    Yk = Y[:, :1000].contiguous()
    k = torch.arange(1000, device=DEV)
    wild = PllState(torch.where(k % 7 == 3, 20.0, settled.theta[:1000]),
                    torch.where(k % 11 == 5, -9.0, settled.freq[:1000]))
    st = scan.FrontState(scan.AgcState(*(v[:1000].contiguous() for v in st0.front.agc)), wild)
    label = f"am_front_scan matrix C=1000 L={M} chunk {chunk} warmup {warmup} unbounded PLL"
    _compare(f"{label} vs the planes launch", held(label, st, Yk, chunk, warmup, (2, 2)),
             scan.front_chunked(amb, st, Yk.T.contiguous(), chunk, warmup))
    # against its plain version: 40 channels, chunk 1000, warmup 2500, a
    # padded last chunk; and the exact route
    Ys = Y[:3900, :40].contiguous()
    st = scan.FrontState(scan.AgcState(*(v[:40].contiguous() for v in st0.front.agc)),
                         PllState(settled.theta[:40].contiguous(),
                                  settled.freq[:40].contiguous()))
    _compare("am_front_scan matrix C=40 L=3900 chunk 1000 warmup 2500 vs its plain version",
             held("am_front_scan matrix C=40 L=3900", st, Ys, 1000, 2500, (2, 2)),
             scan.front_chunked_mc_ref(amb, st, Ys, 1000, 2500))
    _compare("am_front_scan matrix C=40 L=3000 exact vs its plain version",
             held("am_front_scan matrix C=40 L=3000", st, Ys[:3000].contiguous(), 1000, 2500,
                  (1, 1)),
             scan.front_chunked_mc_ref(amb, st, Ys[:3000].contiguous(), 1000, 2500))

    # the rows tail: one launch against the parent's form
    _, (vr, _) = scan.front_chunked_mc(amb, st0.front, Y, chunk, warmup)
    dc0 = (torch.rand(C, generator=g, device=DEV) * 0.1).float()
    de0 = ((torch.rand(C, generator=g, device=DEV) - 0.5) * 0.1).float()
    before = fo._launch.launches
    (dc, de), pcm = fo.linear_tail(amb, dc0, de0, vr)
    torch.cuda.synchronize()
    if fo._launch.launches - before != 1:
        raise AssertionError("the rows tail is not one launch")
    (dc_p, de_p), pcm_p = _parent_tail(amb, cfg, dc0, de0, vr)
    torch.cuda.synchronize()
    same = _bits_equal((dc, de, pcm), (dc_p, de_p, pcm_p))
    worst = min(snr_db(pcm_p[c].double().cpu().numpy(), pcm[c].double().cpu().numpy())
                for c in range(C))
    _check(f"rows linear tail C={C} n={M} vs the parent's row scans and eager line, worst row, "
           f"dB (bit-equal {same})", worst, 120.0, "kernel")

    results["front_mc"] = (cfg, amb, st0.front, Y, vr, dc0, de0)

    # the coherent bank as the benchmark's cam cell runs it (backend 'xla',
    # the sc16 wire): a block launches the matrix instance twice (the
    # chunked launch and the padded tail's re-run) and the rows tail once
    from tpudsp_torch.chains import ChannelizedBank
    bank = ChannelizedBank(cfg, N_PFB, backend="xla", input_format="i16", device=DEV)
    wire = torch.randint(-3000, 3000, (N_PFB, 2), generator=g, device=DEV, dtype=torch.int16)
    counters = lambda: (scan._launch.launches, scan._launch.matrix, fo._launch.launches)
    torch.cuda.synchronize()
    before = counters()
    for _ in range(3):
        bank(wire)
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(counters(), before))
    log(f"kernel[coherent bank, 3 blocks]: launches (am_front_scan, its matrix instance, "
        f"first_order_scan) {got}, expected (6, 6, 3)")
    if got != (6, 6, 3):
        raise AssertionError(f"coherent bank: launches {got}, not (6, 6, 3)")


def _parent_tail(amb, cfg, dc0, de0, vr):
    """The coherent bank's linear tail as the parent ran it: the DC
    tracker's row scan, the eager audio line, the de-emphasis row scan."""
    from tpudsp_torch.cuda import first_order as fo
    from tpudsp_torch.kernels import ampmodem as kam
    dc, dct = fo.first_order_apply_blocked(1.0 - kam.DC_RHO, kam.DC_RHO, dc0, vr)
    de, pcm = fo.first_order_apply_blocked(*cfg.plan.deemph, de0, (vr - dct) * amb.inv_mod)
    return (dc, de), pcm


def time_front_mc():
    """The matrix instance and the rows tail at the coherent bank's shape
    (kernel_front_mc's inputs), each against the form it replaced (the
    transpose, planes, planes launch and unplanes; the two row scans and
    the eager line), by the call (CUDA events) and the kernels' device
    time."""
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.cuda import first_order as fo
    cfg, amb, front, Y, vr, dc0, de0 = results.pop("front_mc")
    (C, M), chunk, warmup = vr.shape, cfg.plan.chunk["xla"], cfg.plan.warmup
    matrix_front = lambda: scan.front_chunked_mc(amb, front, Y, chunk, warmup)
    planes_front = lambda: scan.front_chunked(amb, front, Y.T.contiguous(), chunk, warmup)
    times = {
        "front matrix call_ms": _cuda_ms(matrix_front, 5),
        "front planes (transpose, planes, unplanes) call_ms": _cuda_ms(planes_front, 5),
        "front matrix device_ms": _device_ms(matrix_front, "am_front_scan_kernel<true>", 3),
        "front planes device_ms": _device_ms(planes_front, "am_front_scan_kernel<false>", 3),
        "tail rows call_ms": _cuda_ms(lambda: fo.linear_tail(amb, dc0, de0, vr), 10),
        "tail parent call_ms": _cuda_ms(lambda: _parent_tail(amb, cfg, dc0, de0, vr), 10),
        "tail rows device_ms": _device_ms(lambda: fo.linear_tail(amb, dc0, de0, vr),
                                          "linear_tail_kernel", 10),
    }
    log(f"timing: am_front_scan matrix / rows tail at {C} x {M}: "
        + json.dumps({k: round(v, 4) for k, v in times.items()}))


def ragged_batch():
    """A ragged 3-stream batch (49,923 samples): loud / quiet /
    loud-then-quiet streams whose settled rssi lies near -10 dB and -60 dB,
    far from a -35 dB squelch threshold."""
    import torch
    L = 50_000 - 77
    xs = np.stack([am_signal(L, 48_000.0, 150.0 * (c + 1), amp)
                   for c, amp in enumerate((0.3, 0.001, 0.3))])
    xs[2, L // 2:] *= 0.003
    return torch.from_numpy(xs).to(DEV)


def unbounded_pll_state():
    """PLL states of 3 streams that take the PLL's unbounded instance:
    theta = 20 on stream 1, freq = -9 on stream 2, stream 0 from rest."""
    import torch
    from tpudsp_torch.kernels.pll import PllState
    return PllState(torch.tensor([0.0, 20.0, 0.0], device=DEV),
                    torch.tensor([0.0, 0.0, -9.0], device=DEV))


def kernel_agc(xc):
    """agc_scan's cases; returns its main input."""
    import torch
    from tpudsp_torch.cuda import agc_scan
    from tpudsp_torch.kernels import agc as kagc
    # agc_scan at its main shape: the AGC op's Pallas route on one 4M block
    x4 = torch.from_numpy(am_signal(BLOCK_4M, 2e6, 200.0, noise=0.01,
                                    seed=4)[None]).to(DEV)
    ap = kagc.make_params(alpha=0.01, scale=0.01, device=DEV)
    st = agc_state(1)
    ref, plain_ms = timed(lambda: agc_scan.agc_chunked_pallas_ref(
        ap, st, x4, AGC_CHUNK, AGC_WARMUP))
    _record("agc_scan", _compare(
        "agc_scan pallas route L=4M chunk=1024 warmup=3840",
        agc_scan.agc_chunked_pallas(ap, st, x4, AGC_CHUNK, AGC_WARMUP), ref),
        plain_ms)
    _compare("agc_scan xla route L=4M chunk=warmup=3840",
             agc_scan.agc_chunked(ap, st, x4, CHUNK, WARMUP),
             kagc.agc_apply_chunked(ap, st, x4, CHUNK, WARMUP))
    xs = ragged_batch()
    apq = kagc.make_params(alpha=0.01, scale=0.01, squelch=True,
                           threshold=-35.0, device=DEV)
    stq = agc_state(3, squelch=True)
    _compare("agc_scan pallas route ragged C=3 squelch",
             agc_scan.agc_chunked_pallas(apq, stq, xs, AGC_CHUNK, AGC_WARMUP),
             agc_scan.agc_chunked_pallas_ref(apq, stq, xs, AGC_CHUNK, AGC_WARMUP))
    # the staging edges: chunk 1000 (not a multiple of the stage depth),
    # warmup 3750 = 3.75 chunks (a stage crosses a chunk boundary inside the
    # warmup, and the warmup / chunk boundary), 150 lanes, ragged, squelch
    _compare("agc_scan pallas route ragged C=3 squelch chunk=1000 warmup=3750",
             agc_scan.agc_chunked_pallas(apq, stq, xs, 1000, 3750),
             agc_scan.agc_chunked_pallas_ref(apq, stq, xs, 1000, 3750))
    _compare("agc_scan pallas route ragged C=3 squelch chunk=50 warmup=1030",
             agc_scan.agc_chunked_pallas(apq, stq, xs, 50, 1030),
             agc_scan.agc_chunked_pallas_ref(apq, stq, xs, 50, 1030))
    _compare("agc_scan xla route ragged C=3 squelch chunk=warmup=3840",
             agc_scan.agc_chunked(apq, stq, xs, CHUNK, WARMUP),
             kagc.agc_apply_chunked(apq, stq, xs, CHUNK, WARMUP))
    # the exact single-lane launch at the AMRadio callback's shape
    ref, plain_ms = timed(lambda: kagc.agc_apply(ap, st, xc))
    _record("agc_scan exact", _compare(
        f"agc_scan exact L={N_CALLBACK_OUT}", agc_scan.agc_exact(ap, st, xc), ref),
        plain_ms)
    return x4


def parent_library(name: str):
    """csrc/<name>.cu of the --parent checkout, built as build.py builds
    the port's sources, loaded with the same entry points."""
    from tpudsp_torch.cuda import build
    build.BUILD.mkdir(exist_ok=True)
    out = build.BUILD / f"lib{name}_parent.so"
    res = subprocess.run(build.command(PARENT / "tpudsp_torch" / "csrc" / f"{name}.cu", out),
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in build.SIGNATURES[name].items():
        if hasattr(lib, fn):   # an entry point the parent's source had
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def library_swapped(name: str, lib):
    """The wrappers of csrc/<name>.cu launch ``lib``'s kernel meanwhile."""
    from tpudsp_torch.cuda import build
    own = build.load(name)
    build._libs[name] = lib
    try:
        yield
    finally:
        build._libs[name] = own


def kernel_pll(x, xc):
    """pll_scan's cases: the plain version (>= 90 dB, and whether bit-equal
    is logged) and, with --parent, the parent's kernel bit for bit."""
    import torch
    from tpudsp_torch.cuda import pll_scan
    from tpudsp_torch.kernels import pll as kpll
    z = lambda: torch.zeros(1, device=DEV)
    pst = kpll.PllState(z(), z())
    st3 = kpll.PllState(torch.zeros(3, device=DEV), torch.zeros(3, device=DEV))
    bw = 0.001
    xs = ragged_batch()
    xu = xs[:, :20_000].contiguous()
    ust = unbounded_pll_state()
    cases = [  # (name, kernel call, plain call)
        ("pll_scan chunked L=96000",
         lambda: pll_scan.pll_carrier_scan_chunked(pst, x, bw),
         lambda: kpll.pll_carrier_scan_chunked(pst, x, bw)),
        (f"pll_scan exact L={N_CALLBACK_OUT}",
         lambda: pll_scan.pll_carrier_scan(pst, xc, bw),
         lambda: kpll.pll_carrier_scan(pst, xc, bw)),
        # a ragged last chunk: the padded lanes' state re-derived exactly
        ("pll_scan chunked ragged C=3 L=49923",
         lambda: pll_scan.pll_carrier_scan_chunked(st3, xs, bw),
         lambda: kpll.pll_carrier_scan_chunked(st3, xs, bw)),
        # a chunk shorter than a stage, ragged
        ("pll_scan chunked ragged C=3 chunk=50 warmup=1030",
         lambda: pll_scan.pll_carrier_scan_chunked(st3, xs, bw, 50, 1030),
         lambda: kpll.pll_carrier_scan_chunked(st3, xs, bw, 50, 1030)),
        # the unbounded instance: theta = 20, freq = -9
        ("pll_scan unbounded C=3 chunk=1000 warmup=2500",
         lambda: pll_scan.pll_carrier_scan_chunked(ust, xu, bw, 1000, 2500),
         lambda: kpll.pll_carrier_scan_chunked(ust, xu, bw, 1000, 2500)),
        (f"pll_scan unbounded exact C=3 L={N_CALLBACK_OUT}",
         lambda: pll_scan.pll_carrier_scan(ust, xu[:, :N_CALLBACK_OUT], bw),
         lambda: kpll.pll_carrier_scan(ust, xu[:, :N_CALLBACK_OUT], bw)),
    ]
    parent = parent_library("pll_scan") if PARENT else None
    for name, kernel_call, plain_call in cases:
        out = kernel_call()
        if name.startswith("pll_scan exact"):
            ref, plain_ms = timed(plain_call)
            _record("pll_scan", _compare_pll(name, out, ref), plain_ms)
        else:
            _compare_pll(name, out, plain_call())
        if parent is not None:
            with library_swapped("pll_scan", parent):
                old = kernel_call()
            torch.cuda.synchronize()
            same = _bits_equal((*out[0], out[1]), (*old[0], old[1]))
            log(f"kernel[{name}]: bit-equal to the parent's kernel {same}")
            if not same:
                raise AssertionError(f"kernel[{name}] differs from the parent's kernel")


def first_order_inputs(n: int, rows: int = 0, seed: int = 0):
    """A pcm-rate vr as the AM front leaves it (a DC level, the 1 kHz
    message, noise) of n samples, or ``rows`` rows of it, on the card."""
    import torch
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    shape = (rows, n) if rows else (n,)
    v = 0.3 + 0.15 * np.sin(2 * np.pi * 1000 / 48_000 * t) + 0.01 * rng.standard_normal(shape)
    return torch.from_numpy(v.astype(np.float32)).to(DEV)


def tail_params(carrier: bool):
    """The AM receiver's linear-tail parameters (AMConfig(): rho = 0.9995,
    75 us de-emphasis at 48 kHz, modulation 0.5); DC tracking only with a
    carrier."""
    import torch
    from tpudsp_torch.design import iirdes
    from tpudsp_torch.kernels import agc as kagc
    from tpudsp_torch.kernels import am_backend as kab
    return kab.make_params(kagc.make_params(alpha=0.01, scale=0.01, device=DEV),
                           torch.tensor(0.5, device=DEV),
                           *iirdes.deemphasis_coeffs(48_000.0), carrier=carrier)


def _compare_exact(name, kernel_out, ref_out):
    """Every tensor of kernel_out equals ref_out's bit for bit."""
    import torch
    torch.cuda.synchronize()
    shapes = all(k.shape == r.shape for k, r in zip(kernel_out, ref_out))
    same = shapes and _bits_equal(kernel_out, ref_out)
    wide = lambda t: t.to(torch.complex128 if t.is_complex() else torch.float64)
    max_err = max(float((wide(k) - wide(r)).abs().max())
                  for k, r in zip(kernel_out, ref_out)) if shapes else float("inf")
    log(f"kernel[{name}]: max_abs_err {max_err:.3e}, bit-equal {same}")
    if not same:
        raise AssertionError(f"kernel[{name}] is not bit-equal to its plain version")
    return max_err


def linear_tail_f64(p, dc0: float, de0: float, vr):
    """The AM receiver's linear tail in float64 on the host (scipy's
    lfilter for the two recurrences), from the carries dc0, de0."""
    import scipy.signal as sig
    v = vr.double().cpu().numpy()
    dc = sig.lfilter([1.0 - p.dc_rho], [1.0, -p.dc_rho], v, zi=[p.dc_rho * dc0])[0]
    audio = (v - dc * float(p.use_dc)) * float(p.inv_mod)
    return sig.lfilter([p.deemph_b0], [1.0, -p.deemph_a], audio, zi=[p.deemph_a * de0])[0]


def _flat(tail_out):
    """linear_tail's ((dc_last, de_last), pcm) as (pcm, dc_last, de_last)."""
    return (tail_out[1], *tail_out[0])


def kernel_first_order():
    """first_order_scan's cases, each bit for bit against its plain version
    (kernels/iir) on the same card."""
    import torch
    from tpudsp_torch.cuda import first_order as fo
    from tpudsp_torch.design import iirdes
    from tpudsp_torch.kernels import iir as kiir
    dc = (1.0 - DC_RHO, DC_RHO)
    de = iirdes.deemphasis_coeffs(48_000.0)
    y0 = lambda v: torch.tensor(v, dtype=torch.float32, device=DEV)
    x96 = first_order_inputs(N_OUT_4M, seed=1)
    cases = [
        ("DC tracker n=96000", dc, y0(0.25), x96),
        ("de-emphasis n=96000", de, y0(-0.5), x96),
        ("DC tracker ragged n=12345", dc, y0(0.1), first_order_inputs(12_345, seed=2)),
        ("DC tracker n=7", dc, y0(0.3), first_order_inputs(7, seed=3)),
        ("de-emphasis n=32", de, y0(0.3), first_order_inputs(32, seed=4)),
        ("DC tracker C=3 rows distinct carries n=12345", dc,
         torch.tensor([0.0, 0.5, -1.0], device=DEV), first_order_inputs(12_345, 3, seed=5)),
        # the carry scan's tile edges (a tile is 256 blocks of 32 samples)
        *((f"{w} n={n}", c, y0(0.4), first_order_inputs(n, seed=10 + k))
          for k, (n, w, c) in enumerate(((TILE_FO - 1, "DC tracker", dc), (TILE_FO, "de-emphasis", de),
                                         (TILE_FO + 1, "DC tracker", dc),
                                         (2 * TILE_FO + 5, "de-emphasis", de)))),
        (f"DC tracker C=3 rows distinct carries n={2 * TILE_FO + 5}", dc,
         torch.tensor([0.0, 0.5, -1.0], device=DEV),
         first_order_inputs(2 * TILE_FO + 5, 3, seed=15)),
    ]
    for name, (b0, a), yp, xin in cases:
        _compare_exact(f"first_order_scan {name}",
                       fo.first_order_apply_blocked(b0, a, yp, xin),
                       kiir.first_order_apply_blocked(b0, a, yp, xin))
    # two chained calls, the second from the first's y_last
    x2 = first_order_inputs(2 * 12_345, seed=6)
    k1 = fo.first_order_apply_blocked(*dc, y0(0.2), x2[:12_345])
    k2 = fo.first_order_apply_blocked(*dc, k1[0], x2[12_345:])
    r1 = kiir.first_order_apply_blocked(*dc, y0(0.2), x2[:12_345])
    r2 = kiir.first_order_apply_blocked(*dc, r1[0], x2[12_345:])
    _compare_exact("first_order_scan DC tracker two chained calls n=12345", k1 + k2, r1 + r2)
    # linear_tail_scan at a tile edge
    xe = first_order_inputs(2 * TILE_FO + 5, seed=16)
    pe = tail_params(True)
    _compare_exact(f"linear_tail_scan n={2 * TILE_FO + 5} use_dc 1",
                   _flat(fo.linear_tail(pe, y0(0.3), y0(-0.1), xe)),
                   _flat(kiir.linear_tail(pe, y0(0.3), y0(-0.1), xe)))
    # linear_tail_scan at the AM shape, with and without DC tracking
    for carrier in (True, False):
        p = tail_params(carrier)
        k = fo.linear_tail(p, y0(0.3), y0(-0.1), x96)
        ref, plain_ms = timed(lambda: kiir.linear_tail(p, y0(0.3), y0(-0.1), x96))
        err = _compare_exact(f"linear_tail_scan n=96000 use_dc {int(carrier)}",
                             _flat(k), _flat(ref))
        # the tail's own accuracy, against float64 recurrences
        s = snr_db(linear_tail_f64(p, 0.3, -0.1, x96), k[1].cpu().numpy())
        log(f"kernel[linear_tail_scan n=96000 use_dc {int(carrier)}]: vs float64 {s:.2f} dB "
            f"(bar 130)")
        if not s >= 130.0:
            raise AssertionError("linear_tail_scan is less accurate than its bar")
        if carrier:
            _record("first_order_scan", err, plain_ms)


def phase_kernel():
    x, xc = kernel_front()
    kernel_front_mc()
    x4 = kernel_agc(xc)
    kernel_pll(x, xc)
    results["inputs"] = dict(x96k=x, x4m=x4, xc=xc)
    kernel_first_order()
    kernel_first_order_c64()
    kernel_biquad()
    kernel_shared_chain()
    # halo_async at the AM shape (its main path) and the bank shape
    _record("halo_async", *_compare_halo("halo_async AM shape C=3 Kc=24 D1=125 4M c64 real taps",
                                         halo_am_case(7)))
    for k, fmt in enumerate(("c64", "i16", "u8")):
        _compare_halo(f"halo_async bank shape C=16 Kc=13 D1=10 4M {fmt}",
                      halo_bank_case(fmt, 8 + k))
    # tile edges (8 outputs a thread; 128 outputs a block at the AM shape,
    # 256 at the bank shape): an nj that 8 does not divide, and a shard
    # whose boundary (13 outputs) and interior (184) launches are each
    # shorter than one tile
    x, tail, Tre, Tim, D1, nj = halo_am_case(11)
    _compare_halo(f"halo_async AM shape nj={nj - 3}", (x, tail, Tre, Tim, D1, nj - 3))
    _compare_halo("halo_async bank shape short shard n=1970 nj=197 u8",
                  halo_bank_case("u8", 12, 1970))
    kernel_bank_rotate()


def bank_rotate_case(C: int, nj: int, seed: int, n0: int | None = None):
    """bank_rotate's inputs on the card: y1m (C, nj) complex64 of unit
    noise, random phases, increments and carries, n0 (random unless
    given)."""
    import torch
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((C, nj)) + 1j * rng.standard_normal((C, nj))
    fd = rng.standard_normal(C) + 1j * rng.standard_normal(C)
    n0 = int(rng.integers(0, 2 ** 32)) if n0 is None else n0
    t = lambda v, dt: torch.as_tensor(np.asarray(v), dtype=dt, device=DEV)
    return (t(y.astype(np.complex64), torch.complex64),
            t(rng.integers(0, 2 ** 32, C), torch.int64), t(n0, torch.int64),
            t(rng.integers(0, 2 ** 32, C), torch.int64),
            t(fd.astype(np.complex64), torch.complex64))


def kernel_bank_rotate():
    """The receiver bank's rotation and FM discriminator (cuda/bank_rotate.
    fm_base: one launch) bit for bit against kernels/bank_rotate.fm_base on
    the card: bank16's (16, 800000) from random carries, WBFM mono's
    (1, 200000), 17 channels, 1, 511, 512, 513 and 1025 outputs (the
    512-output chunk's edges), n0 and
    phases across the 2^32 wrap, zero, infinite and NaN samples and a zero
    carry, and three chained calls (the second of one output); each call
    counted once."""
    from tpudsp_torch.cuda import bank_rotate as br
    from tpudsp_torch.kernels import bank_rotate as kbr
    kd = 0.3125

    def check(name, case):
        y1m, phase, n0, dtheta, fd = case
        k0 = br._launch.launches
        k = br.fm_base(y1m, phase, n0, dtheta, 10, fd, kd)
        if br._launch.launches != k0 + 1:
            raise AssertionError(f"bank_rotate {name}: not one launch counted")
        ref, plain_ms = timed(lambda: kbr.fm_base(y1m, phase, n0, dtheta, 10, fd, kd))
        return k, _compare_exact(f"bank_rotate {name}", k, ref), plain_ms

    _, err, plain_ms = check("(16, 800000)", bank_rotate_case(16, 800_000, 70))
    _record("bank_rotate", err, plain_ms)
    for C, nj in ((1, 200_000), (17, 777), (16, 1), (16, 511), (16, 512), (16, 513),
                  (3, 1025)):
        check(f"({C}, {nj})", bank_rotate_case(C, nj, 71 + nj))
    wrap = bank_rotate_case(16, 5000, 72, n0=2 ** 32 - 25_000)
    wrap[1][:] = 2 ** 32 - 1 - wrap[1] % 1000
    check("(16, 5000) across the wrap", wrap)
    y1m, phase, n0, dtheta, fd = bank_rotate_case(6, 2000, 73)
    y1m[0, 100:140] = 0.0
    y1m[1, 511:514] = 0.0
    fd[2] = 0.0
    y1m[3, 40] = complex(float("inf"), 0.0)
    y1m[4, 1023] = complex(float("nan"), 0.5)
    y1m[5, 1999] = complex(0.25, float("-inf"))
    k, _, _ = check("(6, 2000) with zero, infinite and NaN samples",
                    (y1m, phase, n0, dtheta, fd))
    import torch
    # patan2 gives 0 for an infinite or NaN product: the rows stay finite,
    # and channel 5's non-finite last sample is carried as it is
    if not (bool(torch.isfinite(k[0]).all()) and not bool(torch.isfinite(k[1][5]))):
        raise AssertionError("bank_rotate: the non-finite samples did not show as planned")
    y1m, phase, n0, dtheta, fd = bank_rotate_case(16, 3000, 74, n0=2 ** 32 - 15_000)
    kf = rf = fd
    for lo, hi in ((0, 1000), (1000, 1001), (1001, 3000)):
        block = y1m[:, lo:hi].contiguous()
        k = br.fm_base(block, phase, n0, dtheta, 10, kf, kd)
        r = kbr.fm_base(block, phase, n0, dtheta, 10, rf, kd)
        _compare_exact(f"bank_rotate chained call {lo}:{hi} of (16, 3000)", k, r)
        kf, rf, n0 = k[1], r[1], (n0 + 10 * (hi - lo)) & 0xFFFFFFFF


def time_bank_rotate():
    """bank_rotate at bank16's (16, 800000) by the call and by its kernel's
    device time, against its bound (y1m read once and the rows written
    once: 153.6 MB) and against the eager form it replaced in bank_step
    (the phase lattice, the rotation, _fm_base and the last sample's
    clone), in the same call."""
    import torch
    from tpudsp_torch.chains import bank as cbank
    from tpudsp_torch.cuda import bank_rotate as br
    y1m, phase, n0, dtheta, fd = bank_rotate_case(16, 800_000, 75)
    kd, D1 = 0.3125, 10
    call = lambda: br.fm_base(y1m, phase, n0, dtheta, D1, fd, kd)

    def eager():
        theta = cbank.phase_lattice(phase, n0, dtheta, D1, y1m.shape[1])
        y1 = y1m * torch.polar(torch.ones_like(theta), -theta)
        return cbank._fm_base(y1, fd, kd), y1[:, -1].clone()

    out = {"call_ms": _cuda_ms(call, 20),
           "device_ms": _device_ms(call, "bank_rotate_kernel", 20),
           "eager_form_call_ms": _cuda_ms(eager, 10)}
    nbytes = y1m.numel() * (8 + 4)
    ops = y1m.numel() * (OPS_BANK_ROTATION + OPS_FM_DISCRIMINATOR)
    out["bound_ms"] = max(nbytes / HBM_BPS, ops / F32_FLOPS) * 1e3
    log(f"timing: bank_rotate (16, 800000): call {out['call_ms']:.4f} ms, device "
        f"{out['device_ms']:.4f}, bound {out['bound_ms']:.4f} "
        f"({out['device_ms'] / out['bound_ms']:.2f}x by the device); the eager form: call "
        f"{out['eager_form_call_ms']:.4f} ms; {json.dumps(out)}")
    results["kernels"]["bank_rotate"]["ms"] = out["call_ms"]
    bound("bank_rotate", nbytes, ops)
    return out


def phase_chain():
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    cfg = AMConfig()
    n, block = 4_000_000, 2_000_000
    iq = am_signal(n, cfg.iq_rate, 200.0)
    y_ref = oracle_am_chain(iq, cfg)
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.cuda import first_order
    rx = AMReceiver(cfg, block, device=DEV)
    blocks = [torch.from_numpy(iq[:block]).to(DEV), torch.from_numpy(iq[block:]).to(DEV)]
    torch.cuda.synchronize()
    first_order._launch.launches = 0               # the receiver's run starts
    matrix = scan._launch.matrix
    y = torch.cat([rx(b) for b in blocks]).cpu().numpy()
    _expect_launches("chain", first_order._launch.launches, len(blocks))   # ... and ends
    if scan._launch.matrix != matrix:
        raise AssertionError("chain: the AM receiver launched am_front_scan's matrix instance")
    settle = len(y) // 2
    s = snr_db(y_ref[settle:], y[settle:])
    log(f"chain: 2 x 2M-sample blocks vs float64 oracle chain: {s:.2f} dB "
        f"(bar 100), pll_freq {float(rx.metrics.pll_freq):.6f} rad/sample")
    if not (y.shape == y_ref.shape and s >= 100.0):
        raise AssertionError(f"chain vs oracle {s:.2f} dB")


def wire_blocks(nblocks: int, block: int, seed: int):
    """Blocks of one AM stream as c64 (from the quantized values), i16 and
    u8, made from ``seed`` on the host."""
    n = nblocks * block
    x = am_signal(n, 2e6, 200.0, noise=0.01, seed=seed)
    i16 = np.stack([np.round(x.real * 32767), np.round(x.imag * 32767)], -1).astype(np.int16)
    u8 = np.stack([np.round(x.real * 127.5 + 127.5), np.round(x.imag * 127.5 + 127.5)],
                  -1).astype(np.uint8)
    c64 = ((i16[:, 0] + 1j * i16[:, 1]) / 32767).astype(np.complex64)
    c64u = (((u8[:, 0] - 127.5) + 1j * (u8[:, 1] - 127.5)) / 127.5).astype(np.complex64)
    split = lambda a: [a[k * block:(k + 1) * block] for k in range(nblocks)]
    return {"c64": split(c64), "c64_u8": split(c64u), "i16": split(i16), "u8": split(u8)}


def phase_width():
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.cuda import first_order
    data = wire_blocks(3, BLOCK_4M, seed=2)
    rxs = {k: AMReceiver(AMConfig(), BLOCK_4M, "c64" if k.startswith("c64") else k,
                         device=DEV) for k in data}
    gpu = {k: [torch.from_numpy(b).to(DEV) for b in v] for k, v in data.items()}
    torch.cuda.synchronize()
    scan._launch.launches = first_order._launch.launches = 0   # the receiver's run starts
    out = {k: torch.cat([rxs[k](b) for b in gpu[k]]) for k in data}
    torch.cuda.synchronize()
    launches = scan._launch.launches               # ... and ends
    n_tail = first_order._launch.launches
    results["kernels"].setdefault("am_front_scan", {})["launches"] = launches
    results["kernels"].setdefault("first_order_scan", {})["launches"] = n_tail
    _expect_launches("width", n_tail, sum(len(v) for v in gpu.values()))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    settle = N_OUT_4M  # skip the first block (PLL lock, DC tracker settling)
    finite = all(np.all(np.isfinite(v)) and v.shape == (3 * N_OUT_4M,) for v in out.values())
    s16 = snr_db(out["c64"][settle:], out["i16"][settle:])
    s8 = snr_db(out["c64_u8"][settle:], out["u8"][settle:])
    log(f"width: 3 x 4M-sample blocks per format; i16 vs c64 {s16:.2f} dB, "
        f"u8 vs c64 {s8:.2f} dB (bar 90); all finite {finite}; "
        f"am_front_scan launches {launches}")
    if not (finite and s16 >= 90.0 and s8 >= 90.0 and launches > 0):
        raise AssertionError("full-width phase failed")


def phase_sharded():
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.cuda import first_order, halo_async
    from tpudsp_torch.parallel import ShardedAMReceiver, make_mesh
    cfg = AMConfig()
    iq = am_signal(3 * BLOCK_4M, cfg.iq_rate, 200.0)
    blocks = [torch.from_numpy(iq[k * BLOCK_4M:(k + 1) * BLOCK_4M]).to(DEV) for k in range(3)]
    mesh = make_mesh(1, 1, DEV)
    rxs = {h: ShardedAMReceiver(cfg, mesh, BLOCK_4M, halo=h, device=DEV)
           for h in ("async", "ppermute")}
    ref = AMReceiver(cfg, BLOCK_4M, device=DEV)
    torch.cuda.synchronize()
    halo_async._launch.launches = first_order._launch.launches = 0   # the async run starts
    y_as = torch.cat([rxs["async"](b) for b in blocks])
    torch.cuda.synchronize()
    launches = halo_async._launch.launches         # ... and ends
    results["kernels"].setdefault("halo_async", {})["launches"] = launches
    # two per block: the DC tracker's rows and the de-emphasis
    _expect_launches("sharded async", first_order._launch.launches, 2 * len(blocks))
    first_order._launch.launches = 0               # the ppermute run starts
    y_pp = torch.cat([rxs["ppermute"](b) for b in blocks]).cpu().numpy()
    _expect_launches("sharded ppermute", first_order._launch.launches, 2 * len(blocks))
    y_ref = torch.cat([ref(b) for b in blocks]).cpu().numpy()
    y_as = y_as.cpu().numpy()
    y_or = oracle_am_chain(iq, cfg)
    settle = N_OUT_4M  # the oracle past the first block (PLL lock, DC settling)
    s = {"async vs ppermute": snr_db(y_pp, y_as), "async vs AMReceiver": snr_db(y_ref, y_as),
         "ppermute vs AMReceiver": snr_db(y_ref, y_pp),
         "async vs float64 oracle": snr_db(y_or[settle:], y_as[settle:])}
    finite = all(v.shape == (3 * N_OUT_4M,) and np.all(np.isfinite(v)) for v in (y_as, y_pp))
    log("sharded: ShardedAMReceiver on a 1x1 mesh, 3 x 4M-sample c64 blocks: "
        + ", ".join(f"{k} {v:.2f} dB" for k, v in s.items())
        + f" (bar 100); all finite {finite}; halo_async launches {launches}")
    if not (finite and min(s.values()) >= 100.0 and launches > 0):
        raise AssertionError("sharded phase failed")


def am_radio_class(liquiddsp):
    """The reference README's AMRadio, verbatim (examples/am_radio.py:15-31)."""
    class AMRadio:
        def __init__(self, bandwidth=15000, iq_rate=2000000, pcm_rate=48000):
            self.bandpass = liquiddsp.ComplexIIRFilter(
                filter_type="cheby2", order=8, Fc=bandwidth / iq_rate)
            self.resample = liquiddsp.ComplexResampler(
                rate=pcm_rate / iq_rate, Fc=pcm_rate / iq_rate)
            self.am = liquiddsp.AmpModem(modulation=0.5, type="dsb", carrier=True)
            self.audio_filter = liquiddsp.DeemphasisFilter(pcm_rate)
            self.agc = liquiddsp.AGC()
            self.agc.lock = False
            self.agc.scale = 0.01
            self.pcm = b""

        def __call__(self, iq):
            pcm = self.audio_filter(self.am(self.agc(self.resample(self.bandpass(iq)))))
            self.pcm += pcm.tobytes()
            return pcm

    return AMRadio


def radio_raw(n: int, iq_rate: float = 2e6):
    """examples/am_radio.py's int16 IQ: a 1 kHz tone, 50% AM, 200 Hz off."""
    t = np.arange(n)
    msg = np.sin(2 * np.pi * 1000.0 / iq_rate * t)
    iq = (1 + 0.5 * msg) * 0.3 * np.exp(2j * np.pi * 200.0 / iq_rate * t)
    raw = np.empty(2 * n, np.int16)
    raw[0::2] = np.clip(iq.real * 32767, -32767, 32767)
    raw[1::2] = np.clip(iq.imag * 32767, -32767, 32767)
    return raw


def phase_compat():
    import torch
    import tpudsp_torch.compat as liquiddsp
    from tpudsp_torch.cuda import agc_scan, first_order, pll_scan
    from tpudsp_torch.design import firdes, iirdes
    AMRadio = am_radio_class(liquiddsp)
    raw = radio_raw(N_RADIO)
    callbacks = [raw[2 * i: 2 * (i + CALLBACK)].tobytes()
                 for i in range(0, N_RADIO, CALLBACK)]
    radio = AMRadio()
    if radio.agc.device.type != "cuda":
        raise AssertionError(f"compat ops built on {radio.agc.device}")
    torch.cuda.synchronize()
    agc_scan._launch.launches = pll_scan._launch.launches = 0   # the path starts
    first_order._launch.launches = 0
    for cb in callbacks:
        radio(liquiddsp.bytes_to_iq(cb))
    torch.cuda.synchronize()
    launches = {"agc_scan": agc_scan._launch.launches,         # ... and ends
                "pll_scan": pll_scan._launch.launches,
                "first_order_scan": first_order._launch.launches}
    # two per callback: AmpModem's DC tracker and DeemphasisFilter
    _expect_launches("compat", launches["first_order_scan"], 2 * len(callbacks))
    y = np.frombuffer(radio.pcm, np.float32)
    rate = 48_000 / 2e6
    sos = iirdes.iirdes_sos("cheby2", "lowpass", 8, 15000 / 2e6, 0.3, 0.7, 60.0)
    y_ref = oracle_chain(liquiddsp.bytes_to_iq(raw.tobytes()), sos,
                         firdes.resamp_bank(20, rate, 60.0, 13), rate, 0.01,
                         0.01, 0.5, 48_000.0)
    settle = len(y_ref) // 2
    s = snr_db(y_ref[settle:], y[settle:])
    log(f"compat: README AMRadio on tpudsp_torch.compat, {len(callbacks)} "
        f"callbacks of {CALLBACK} samples -> {len(y)} pcm samples; vs float64 "
        f"oracle chain {s:.2f} dB (bar 100); launches {launches}")
    if not (y.shape == y_ref.shape and np.all(np.isfinite(y)) and s >= 100.0
            and min(launches.values()) > 0):
        raise AssertionError("compat AMRadio phase failed")

    # the AGC op's Pallas route over three 4M-sample blocks, carried state
    blocks = wire_blocks(3, BLOCK_4M, seed=6)["c64"]
    agc = liquiddsp.AGC(throughput_mode=True, use_pallas=True)
    agc.scale = 0.01
    torch.cuda.synchronize()
    agc_scan._launch.launches = 0                  # the path starts
    outs = [agc(b) for b in blocks]
    torch.cuda.synchronize()
    n_agc = agc_scan._launch.launches              # ... and ends
    finite = all(o.shape == (BLOCK_4M,) and np.all(np.isfinite(o)) for o in outs)
    level = float(np.mean(np.abs(outs[-1][-100_000:])))
    log(f"compat: AGC(throughput_mode=True, use_pallas=True) over 3 x 4M-sample "
        f"blocks: finite {finite}, settled |y| {level:.5f} (scale 0.01), "
        f"agc_scan launches {n_agc}")
    if not (finite and n_agc > 0 and abs(level / 0.01 - 1) < 0.2):
        raise AssertionError("compat AGC phase failed")
    k = results["kernels"]
    k.setdefault("agc_scan", {})["launches"] = launches["agc_scan"] + n_agc
    k.setdefault("pll_scan", {})["launches"] = launches["pll_scan"]
    k.setdefault("first_order_scan", {})["launches"] = (k["first_order_scan"].get("launches", 0)
                                                        + launches["first_order_scan"])
    results["callbacks"] = callbacks


# --------------------------------------------------------------------------
# the compensated SOS cascade, the complex one-pole, the AM receiver's other
# options and the rest of the class surface

def oracle_module(name: str):
    """tests/oracle/<name>.py (numpy and scipy only), loaded by path: an
    installed package named "tests" may shadow the repo's."""
    import importlib.util
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "tests" / "oracle" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def noise_c64(n: int, seed: int, scale: float = 0.5):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def clowpass_scan_sos():
    """CLowpassIIR(order=8, Fc=0.0075, mode="scan")'s design (its
    defaults: butter, Ap 0.5, As 20)."""
    from tpudsp_torch.design import iirdes
    return iirdes.iirdes_sos("butter", "lowpass", 8, 0.0075, 0.1, 0.5, 20.0)


def dc_block_sos():
    """BroadcastAM's DC block: cheby2 highpass, order 3, fc = 20/48000."""
    from tpudsp_torch.design import iirdes
    return iirdes.iirdes_sos("cheby2", "highpass", 3, 20.0 / 48000.0, Ap=0.5, As=20.0)


def biquad_edges():
    """Lengths at biquad_scan's own edges: its block of L samples, its tile
    of T and its fold window of W tiles (kernels/iir's SOS_L, SOS_TILE,
    SOS_WINDOW), and 1 and 7."""
    from tpudsp_torch.kernels import iir as kiir
    L, T = kiir.SOS_L, kiir.SOS_TILE
    WT = kiir.SOS_WINDOW * T
    return (1, 7, L - 1, L, L + 1, T - 1, T, T + 1, 2 * T + 5, WT - 1, WT, WT + 1, 2 * WT + 5)


def kernel_biquad():
    """biquad_scan's cases, each bit for bit against its plain version
    (kernels/iir.sos_apply_df) on the same card: the main shape, lengths at
    its block, tile and fold-window edges, real and complex rows, carried
    states, chained calls; and the cascade against float64."""
    import torch
    from tpudsp_torch.cuda import biquad_scan as bq
    from tpudsp_torch.design import iirdes
    from tpudsp_torch.kernels import iir as kiir
    hard = iirdes.iirdes_sos("cheby2", "lowpass", 8, 0.0075, As=60.0, Ap=0.5)
    tab = lambda sos: torch.from_numpy(kiir.sos_table(sos)).to(DEV)
    rng = np.random.default_rng(20)

    def state(sos, cplx):
        v = rng.standard_normal((len(sos), 2)) * 0.1
        if cplx:
            v = v + 1j * rng.standard_normal((len(sos), 2)) * 0.1
        return torch.from_numpy(v.astype(np.complex64 if cplx else np.float32)).to(DEV)

    def signal(n, cplx, seed):
        x = noise_c64(n, seed)
        return torch.from_numpy(x if cplx else x.real.copy()).to(DEV)

    # the main shape: CLowpassIIR(order=8, Fc=0.0075, mode="scan") on the
    # README's 2^18-sample callback of complex64
    _, sos, st, x = biquad_cases()[0]
    ref, plain_ms = timed(lambda: kiir.sos_apply_df(tab(sos), st, x))
    err = _compare_exact(f"biquad_scan CLowpassIIR order 8 c64 n={N_SURFACE}",
                         bq.sos_apply_df(tab(sos), st, x), ref)
    _record("biquad_scan", err, plain_ms)
    # biquad_scan's own block, tile and fold-window edges, real and complex
    # rows, random carried states
    for k, n in enumerate(biquad_edges()):
        for cplx, design, name in ((True, hard, "cheby2 order 8"),
                                   (False, dc_block_sos(), "DC block")):
            xs, s0 = signal(n, cplx, 30 + k), state(design, cplx)
            _compare_exact(f"biquad_scan {name} {'c64' if cplx else 'f32'} n={n}",
                           bq.sos_apply_df(tab(design), s0, xs),
                           kiir.sos_apply_df(tab(design), s0, xs))
    # chained calls carrying the state, the last across a fold window
    T, WT = kiir.SOS_TILE, kiir.SOS_WINDOW * kiir.SOS_TILE
    xs = signal(7 + T + 1 + WT + 5, True, 40)
    ks = rs = state(hard, True)
    kout, rout = [], []
    for a, b in ((0, 7), (7, 7 + T + 1), (7 + T + 1, xs.shape[0])):
        ks, ky = bq.sos_apply_df(tab(hard), ks, xs[a:b])
        rs, ry = kiir.sos_apply_df(tab(hard), rs, xs[a:b])
        kout += [ks, ky]
        rout += [rs, ry]
    _compare_exact("biquad_scan cheby2 order 8 c64 three chained calls", kout, rout)
    # against float64: the hard config (a plain f32 scan floors near 60 dB
    # there) and BroadcastAM's near-unit-pole DC block
    lo = oracle_module("liquid_oracle")
    for name, design, xs in (("cheby2 order 8 c64", hard, signal(N_ORACLE, True, 41)),
                             ("DC block f32", dc_block_sos(),
                              signal(N_ORACLE, False, 42) + 1.0)):
        _, y = bq.sos_apply_df(tab(design), torch.zeros((len(design), 2), dtype=xs.dtype,
                                                         device=DEV), xs)
        s = snr_db(lo.SosFilterOracle(design)(xs.cpu().numpy()), y.cpu().numpy())
        log(f"kernel[biquad_scan {name} n={N_ORACLE}]: vs float64 {s:.2f} dB (bar 120)")
        if not s >= 120.0:
            raise AssertionError("biquad_scan is less accurate than its bar")


def kernel_first_order_c64():
    """first_order_scan over a complex64 row, bit for bit against its plain
    version (kernels/iir.first_order_apply_blocked_c64) at the main shape
    (FMStereo's pilot smoother on a 2^18-sample block), at a block and the
    tile edges and over chained calls; and against float64."""
    import torch
    from tpudsp_torch.cuda import first_order as fo
    from tpudsp_torch.kernels import iir as kiir
    rho = 0.999                   # the pilot smoothers' pole
    ab = (1.0 - rho, rho)
    yp = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=DEV)
    x = torch.from_numpy(noise_c64(N_SURFACE, 50)).to(DEV)
    ref, plain_ms = timed(lambda: kiir.first_order_apply_blocked_c64(*ab, yp, x))
    err = _compare_exact(f"first_order_scan_c64 rho=0.999 n={N_SURFACE}",
                         fo.first_order_apply_blocked_c64(*ab, yp, x), ref)
    _record("first_order_scan_c64", err, plain_ms)
    results["inputs"]["c64"] = (ab, yp, x)
    for n in (7, 32, 33, TILE_FO - 1, TILE_FO, TILE_FO + 1, 2 * TILE_FO + 5):
        xs = x[:n].contiguous()
        _compare_exact(f"first_order_scan_c64 n={n}", fo.first_order_apply_blocked_c64(*ab, yp, xs),
                       kiir.first_order_apply_blocked_c64(*ab, yp, xs))
    k1 = fo.first_order_apply_blocked_c64(*ab, yp, x[:12_345])
    k2 = fo.first_order_apply_blocked_c64(*ab, k1[0], x[12_345:40_000])
    r1 = kiir.first_order_apply_blocked_c64(*ab, yp, x[:12_345])
    r2 = kiir.first_order_apply_blocked_c64(*ab, r1[0], x[12_345:40_000])
    _compare_exact("first_order_scan_c64 two chained calls", k1 + k2, r1 + r2)
    import scipy.signal as sig
    xo = x[:N_ORACLE].cpu().numpy().astype(np.complex128)
    y64 = sig.lfilter([ab[0]], [1.0, -rho], xo, zi=[rho * complex(yp.cpu())])[0]
    s = snr_db(y64, fo.first_order_apply_blocked_c64(*ab, yp, x[:N_ORACLE])[1].cpu().numpy())
    log(f"kernel[first_order_scan_c64 n={N_ORACLE}]: vs float64 {s:.2f} dB (bar 130)")
    if not s >= 130.0:
        raise AssertionError("first_order_scan_c64 is less accurate than its bar")


def kernel_shared_chain():
    """The blocked scans share one scratch buffer per stream (cuda/launch.
    chain), each kernel's links LINK slots wide with the flag last. Three
    rounds of biquad_scan, first_order_scan's complex64 call, its real rows
    and linear_tail_scan, back to back on the stream over four tiles, from
    denormal states and inputs a few ulps of the least denormal wide (what
    a state decaying through silence leaves in the links, values whose bits
    read as small integers, like the epochs): each bit for bit against its
    plain version, and after each round every flag slot of the buffer holds
    0 or an epoch this stream has used, never a value. biquad_scan runs
    over 3 tiles past one fold window (tile and window links), the others
    over 3 tiles of first_order_scan's and 5 samples."""
    import torch
    from tpudsp_torch.cuda import biquad_scan as bq
    from tpudsp_torch.cuda import first_order as fo
    from tpudsp_torch.cuda import launch
    from tpudsp_torch.kernels import iir as kiir
    n = 3 * TILE_FO + 5
    nb = (kiir.SOS_WINDOW + 3) * kiir.SOS_TILE + 5
    sos = clowpass_scan_sos()
    tab = torch.from_numpy(kiir.sos_table(sos)).to(DEV)
    tiny = lambda x: torch.from_numpy(np.asarray(x * np.float32(1e-43))).to(DEV)   # 71 ulps
    rho = (1.0 - 0.999, 0.999)
    p = tail_params(True)
    for r in range(3):
        x = tiny(noise_c64(n, 70 + r))
        xb = tiny(noise_c64(nb, 85 + r))
        xr = tiny(noise_c64(3 * n, 73 + r).real.reshape(3, n).copy())
        v0 = tiny(noise_c64(2 * len(sos), 76 + r).reshape(len(sos), 2))
        y0 = tiny(noise_c64(1, 79 + r)[0])
        c0 = tiny(noise_c64(3, 82 + r).real.copy())
        t0, t1 = tiny(np.float32(1.0)), tiny(np.float32(-2.0))
        k = [bq.sos_apply_df(tab, v0, xb), fo.first_order_apply_blocked_c64(*rho, y0, x),
             fo.first_order_apply_blocked(*rho, c0, xr), _flat(fo.linear_tail(p, t0, t1, xr[0]))]
        ref = [kiir.sos_apply_df(tab, v0, xb), kiir.first_order_apply_blocked_c64(*rho, y0, x),
               kiir.first_order_apply_blocked(*rho, c0, xr),
               _flat(kiir.linear_tail(p, t0, t1, xr[0]))]
        for name, kk, rr in zip((f"biquad_scan n={nb}", f"first_order_scan c64 n={n}",
                                 f"first_order_scan rows n={n}", f"linear_tail_scan n={n}"),
                                k, ref):
            _compare_exact(f"shared scratch round {r}: {name} denormal", kk, rr)
        torch.cuda.synchronize()
        dev = x.device
        scratch, _, epoch = launch._chains[(dev, launch.stream(dev))]
        flags = scratch[4 + launch.LINK - 1::launch.LINK].cpu()
        if not bool(((flags >= 0) & (flags <= epoch)).all()):
            raise AssertionError(f"shared scratch round {r}: a flag slot holds a value "
                                 f"(flags {flags.min()}..{flags.max()}, last epoch {epoch})")
        log(f"kernel[shared scratch round {r}]: {flags.numel()} flag slots in 0..{epoch}")


COUNTED = ("am_front_scan", "agc_scan", "pll_scan", "first_order_scan",
           "first_order_scan_c64", "first_order_scan_mc", "fm_deemph_cols", "biquad_scan",
           "halo_async", "pfb_branch", "bank_rotate")


def _counters():
    """Every kernel wrapper's launch counter, by kernel name: (object,
    attribute holder)."""
    from tpudsp_torch.cuda import (agc_scan, bank_rotate, biquad_scan, first_order, halo_async,
                                   pfb, pll_scan)
    from tpudsp_torch.cuda import am_backend_scan as scan
    return {"am_front_scan": scan._launch, "agc_scan": agc_scan._launch,
            "pll_scan": pll_scan._launch, "first_order_scan": first_order._launch,
            "first_order_scan_c64": first_order.first_order_apply_blocked_c64,
            "first_order_scan_mc": first_order.first_order_apply_blocked_mc,
            "fm_deemph_cols": first_order.fm_deemph_cols,
            "biquad_scan": biquad_scan.sos_apply_df, "halo_async": halo_async._launch,
            "pfb_branch": pfb.branch_accumulate, "bank_rotate": bank_rotate._launch}


def zero_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    got = {k: fn.launches for k, fn in _counters().items()}
    # the FM instance of the column kernel counts in the column carry's
    # counter too (the benchmark's trace check reads that one): here
    # first_order_scan_mc is the f32 instance alone
    got["first_order_scan_mc"] -= got["fm_deemph_cols"]
    return got


def expect_counts(path: str, got: dict, want: dict):
    """A path's launches of every kernel: exactly ``want`` (0 where not
    named); each counts towards its kernel's launches on the main paths."""
    want = {k: want.get(k, 0) for k in got}
    log(f"{path}: launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{path}: launches {got}, not {want}")
    for k, v in got.items():
        if v:
            entry = results["kernels"].setdefault(k, {})
            entry["launches"] = entry.get("launches", 0) + v


def _med(times):
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med


# the AM receiver's other options, and each one's launches per 4M-sample
# block at AMConfig(): the chunked AGC's 25 lanes need no tail; the chunked
# PLL's 47 lanes of 2048 have a padded last one, re-run exactly
AM_OPTIONS = {
    "exact": (dict(exact=True),
              {"agc_scan": 1, "pll_scan": 1, "first_order_scan": 2}),
    "xla": (dict(backend="xla"), {"agc_scan": 1, "pll_scan": 2, "first_order_scan": 2}),
    "composed": (dict(plan="composed"), {"am_front_scan": 1, "first_order_scan": 1}),
}


def phase_options():
    """AMReceiver with exact=True, backend='xla' and plan='composed' on
    4M-sample c64 blocks: each >= 100 dB against the float64 oracle chain
    past the first block, composed against fused >= 70 dB, the XLA back end
    against the fused-kernel one >= 65 dB, each path's launches, and each
    path's block time (median of 5, spread) beside the fused plan's."""
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    cfg = AMConfig()
    data = wire_blocks(6, BLOCK_4M, seed=4)["c64"]
    gpu = [torch.from_numpy(b).to(DEV) for b in data]
    y_or = oracle_am_chain(np.concatenate(data[:2]), cfg)
    settle = N_OUT_4M   # past the first block (PLL lock, DC settling)
    rxs = {"fused": AMReceiver(cfg, BLOCK_4M, device=DEV)}
    ys = {"fused": torch.cat([rxs["fused"](b) for b in gpu[:2]]).cpu().numpy()}
    for name, (kw, per_block) in AM_OPTIONS.items():
        rx = rxs[name] = AMReceiver(cfg, BLOCK_4M, device=DEV, **kw)
        torch.cuda.synchronize()
        zero_counts()                                  # the option's run starts
        y = torch.cat([rx(b) for b in gpu[:2]])
        torch.cuda.synchronize()
        expect_counts(f"options {name}", read_counts(),   # ... and ends
                      {k: 2 * v for k, v in per_block.items()})
        ys[name] = y = y.cpu().numpy()
        s = snr_db(y_or[settle:], y[settle:])
        finite = y.shape == y_or.shape and bool(np.all(np.isfinite(y)))
        log(f"options: AMReceiver {name} ({kw}), 2 x 4M-sample c64 blocks: vs float64 "
            f"oracle chain {s:.2f} dB (bar 100), plan {rx.plan}, finite {finite}")
        if not (finite and s >= 100.0):
            raise AssertionError(f"options {name} vs oracle {s:.2f} dB")
    s_cf = snr_db(ys["composed"][200:], ys["fused"][200:])
    s_xk = snr_db(ys["xla"][3000:], ys["fused"][3000:])
    log(f"options: composed vs fused {s_cf:.2f} dB (bar 70); xla back end vs fused-kernel "
        f"back end {s_xk:.2f} dB (bar 65)")
    if not (s_cf >= 70.0 and s_xk >= 65.0):
        raise AssertionError("options: the plans or back ends disagree")
    for name, rx in rxs.items():
        med, spread = _block_times(rx, gpu)
        log(f"timing: AMReceiver {name} c64 4M-sample block: median {med * 1e3:.3f} ms of 5 "
            f"(spread {spread * 100:.1f}%), {BLOCK_4M / med / 1e6:.1f} Msamp/s; profiler "
            f"window: {json.dumps(profile_block(rx, gpu))}")


def _op_times(op, blocks):
    """Host seconds of op on blocks[1:] after a warm-up call on blocks[0]
    (each call returns numpy, so each ends synchronised): (median,
    spread / median)."""
    op(blocks[0])
    times = []
    for b in blocks[1:]:
        t0 = time.perf_counter()
        op(b)
        times.append(time.perf_counter() - t0)
    return _med(times)


def _score(what: str, ref, y, bar: float):
    s = snr_db(ref, y)
    ok = np.shape(ref) == np.shape(y) and s >= bar
    log(f"surface: {what}: {s:.2f} dB (bar {bar:g})")
    if not ok:
        raise AssertionError(f"surface: {what} {s:.2f} dB")


def _run_path(name: str, op, blocks, want_per_call: dict):
    """op over blocks on the card, its launches counted: returns the
    outputs."""
    import torch
    torch.cuda.synchronize()
    zero_counts()                                      # the path starts
    outs = [op(b) for b in blocks]
    torch.cuda.synchronize()
    expect_counts(f"surface {name}", read_counts(),    # ... and ends
                  {k: len(blocks) * v for k, v in want_per_call.items()})
    if not all(np.all(np.isfinite(o)) for o in outs):
        raise AssertionError(f"surface {name}: output not finite")
    return outs


def broadcast_am_f64(x, slen: int = 25):
    """BroadcastAM's reference topology in float64 (tests/oracle/
    composite_oracle.BroadcastAMOracle's loop, with the port's designs):
    the Kaiser lowpass and the delay are LTI, so they run over the block;
    the carrier PLL runs sample by sample on liquid's 32-bit NCO; the DC
    block is SosFilterOracle's recurrence."""
    from tpudsp_torch.design import firdes
    lo = oracle_module("liquid_oracle")
    x = np.asarray(x, np.complex128)
    n = len(x)
    x0 = np.convolve(x, firdes.kaiser_lowpass(2 * slen + 1, 0.01, 40.0))[:n]
    x1 = np.concatenate([np.zeros(slen), x])[:n]
    nco = lo.NcoOracle()
    nco.set_pll_bandwidth(0.001)
    theta = np.empty(n)
    for k in range(n):
        theta[k] = nco.phase
        nco.pll_step(np.angle(x0[k] * np.exp(-1j * theta[k])))
        nco.step()
    return lo.SosFilterOracle(dc_block_sos())((x1 * np.exp(-1j * theta)).real).real


def fm_stereo_mono_f64(x, iq_rate: float = 600_000.0, pcm_rate: float = 48_000.0):
    """The left channel of tests/oracle/composite_oracle.FMStereoOracle
    (pll_bw 1e-5, warm start: the reference topology's pilot loop locked)
    in float64 with the port's designs: freqdem (kd = 4) over the block,
    the pilot NCO sample by sample, then the de-emphasis (the same
    recurrence as FirstOrderOracle, by scipy) and ResampOracle over the
    block (both LTI or block-invariant)."""
    import scipy.signal as sig
    from tpudsp_torch.design import firdes, iirdes
    lo = oracle_module("liquid_oracle")
    x = np.asarray(x, np.complex128)
    s = np.angle(np.conj(np.concatenate([[1.0], x[:-1]])) * x) / (2 * np.pi * 4.0)
    nco = lo.NcoOracle()
    nco.set_pll_bandwidth(1e-5)
    nco.set_frequency(2 * np.pi * 19000.0 / iq_rate)
    perr = 0.0
    left = np.empty(len(x))
    for k in range(len(x)):
        sc = s[k] * np.exp(-1j * nco.phase)
        perr = 0.999 * perr + 0.001 * np.angle(sc)
        sc = sc * np.exp(-1j * nco.phase)
        nco.pll_step(perr)
        nco.step()
        left[k] = s[k] + sc.real
    b0, a = iirdes.deemphasis_coeffs(iq_rate)
    left = sig.lfilter([b0], [1.0, -a], left)
    rate = pcm_rate / iq_rate
    m, fc, As, npfb = firdes.default_resamp_params(rate)
    return lo.ResampOracle(firdes.resamp_bank(m, fc, As, npfb), rate)(left)


def hilbert_f64(h, x, interp: bool):
    """HilbertTransform's interp (complex -> real at 2x) or decim (real ->
    complex at 1/2) in float64 from a zero state."""
    x = np.asarray(x, np.complex128 if interp else np.float64)
    if interp:
        up = np.zeros(2 * len(x), np.complex128)
        up[::2] = 2.0 * x
        xf = np.convolve(up, h)[:len(up)]
        return (xf * 1j ** np.arange(len(up))).real
    xf = np.convolve(x * (-1j) ** np.arange(len(x)), h)[:len(x)]
    return 2.0 * xf[::2]


def phase_surface():
    """Every class beyond the README's AMRadio, built with no device (so
    on the card), at the sizes its users call: each against its float64
    oracle on a prefix of <= 65,536 samples at FIDELITY.md section 1's
    bars, its launches counted, and its call timed (median of 5)."""
    import tpudsp_torch.compat as liquiddsp
    from tpudsp_torch.design import firdes
    lo = oracle_module("liquid_oracle")
    nb = 6                                    # blocks: one warm-up, five timed
    times = {}

    def blocks(x, size):
        return [x[k * size:(k + 1) * size] for k in range(len(x) // size)]

    # CLowpassIIR in scan mode on complex64 callbacks
    f = liquiddsp.CLowpassIIR(order=8, Fc=0.0075, mode="scan")
    if f.device.type != DEV or f.mode != "scan":
        raise AssertionError(f"CLowpassIIR built on {f.device} in mode {f.mode}")
    x = noise_c64(nb * N_SURFACE, 60)
    y = np.concatenate(_run_path("CLowpassIIR scan", f, blocks(x, N_SURFACE),
                                 {"biquad_scan": 1}))
    _score(f"CLowpassIIR(order=8, Fc=0.0075, mode='scan') vs float64 n={N_ORACLE}",
           lo.SosFilterOracle(clowpass_scan_sos())(x[:N_ORACLE]), y[:N_ORACLE], 120.0)
    times["CLowpassIIR scan"] = _op_times(liquiddsp.CLowpassIIR(order=8, Fc=0.0075, mode="scan"),
                                          blocks(x, N_SURFACE))
    # BroadcastAM on the callback's 6291 pcm samples at 48 kHz
    t = np.arange(10 * N_CALLBACK_OUT)
    m = np.sin(2 * np.pi * 2000.0 / 48_000.0 * t)
    xb = ((1.0 + 0.5 * m) * np.exp(2j * np.pi * 0.001 * t + 0.5j)).astype(np.complex64)
    op = liquiddsp.BroadcastAM()
    y = np.concatenate(_run_path("BroadcastAM", op, blocks(xb, N_CALLBACK_OUT),
                                 {"pll_scan": 1, "biquad_scan": 1}))
    _score(f"BroadcastAM vs float64 oracle past 30000 of n={len(xb)}",
           broadcast_am_f64(xb)[30_000:], y[30_000:].astype(np.float64), 110.0)
    times["BroadcastAM"] = _op_times(liquiddsp.BroadcastAM(), blocks(xb, N_CALLBACK_OUT))
    # FMStereo on 2^18-sample composite blocks: separation at full size,
    # the mono path against the reference topology on a 65,536 prefix
    n = nb * N_SURFACE
    tone = lambda fq: np.sin(2 * np.pi * fq / 600_000.0 * np.arange(n))
    fm = oracle_module("fm_stereo_checks")
    xs = fm.stereo_composite(n, tone(800.0), tone(2300.0))
    op = liquiddsp.FMStereo(600_000.0, 48_000.0)
    ys = np.concatenate(_run_path("FMStereo", op, blocks(xs, N_SURFACE),
                                  {"first_order_scan_c64": 2, "first_order_scan": 1}))
    sep = fm.separation_db(ys, 800.0, 2300.0)
    log(f"surface: FMStereo L/R separation {sep[0]:.2f} / {sep[1]:.2f} dB (bar 60), "
        f"{ys.shape} pcm")
    if not (ys.shape[1] == 2 and min(sep) >= 60.0):
        raise AssertionError("surface: FMStereo does not separate")
    la = tone(1000.0)[:N_ORACLE] + 0.5 * tone(6300.0)[:N_ORACLE]
    xm = fm.stereo_composite(N_ORACLE, la, la)
    g, s = fm.mono_agreement(fm_stereo_mono_f64(xm), liquiddsp.FMStereo(600_000.0, 48_000.0)(xm)[:, 0])
    log(f"surface: FMStereo mono path vs reference-topology oracle n={N_ORACLE}: "
        f"{s:.2f} dB (bar 30), gain {g:.4f}")
    if not (0.9 < g < 1.1 and s >= 30.0):
        raise AssertionError("surface: FMStereo mono path disagrees with its oracle")
    times["FMStereo"] = _op_times(liquiddsp.FMStereo(600_000.0, 48_000.0), blocks(xs, N_SURFACE))
    # NCO, FreqDem, SSBDemod, Delay, HilbertTransform on 2^18 samples
    xn = noise_c64(nb * N_SURFACE, 61)
    nco = liquiddsp.NCO()
    nco.freq, nco.phase = 0.3, 1.0
    y = np.concatenate(_run_path("NCO", nco, blocks(xn, N_SURFACE), {}))
    orc = lo.NcoOracle()
    orc.set_frequency(0.3)
    orc.set_phase(1.0)
    _score(f"NCO mix_up vs liquid's 32-bit accumulator n={N_ORACLE}",
           orc.mix_up(xn[:N_ORACLE]), y[:N_ORACLE], 120.0)
    times["NCO"] = _op_times(nco, blocks(xn, N_SURFACE))
    kd = 0.1
    msg = 0.8 * np.sin(2 * np.pi * 1000.0 / 48_000.0 * np.arange(nb * N_SURFACE))
    xf = np.exp(1j * 2 * np.pi * kd * np.cumsum(msg)).astype(np.complex64)
    y = np.concatenate(_run_path("FreqDem", liquiddsp.FreqDem(kd), blocks(xf, N_SURFACE), {}))
    _score(f"FreqDem vs float64 n={N_ORACLE}", lo.FreqDemOracle(kd)(xf[:N_ORACLE]),
           y[:N_ORACLE], 100.0)
    times["FreqDem"] = _op_times(liquiddsp.FreqDem(kd), blocks(xf, N_SURFACE))
    fq = 0.03
    xu = np.exp(2j * np.pi * fq * np.arange(nb * N_SURFACE)).astype(np.complex64)
    y = np.concatenate(_run_path("SSBDemod", liquiddsp.SSBDemod("usb"), blocks(xu, N_SURFACE), {}))
    d = 2 * liquiddsp.SSBDemod.HILB_M
    ref = 2 * np.cos(2 * np.pi * fq * (np.arange(N_ORACLE) - d))
    _score(f"SSBDemod usb vs the analytic reference n={N_ORACLE}",
           ref[1000:-1000], y[1000:N_ORACLE - 1000], 65.0)
    z = liquiddsp.SSBDemod("lsb")(xu[:N_ORACLE])
    rej = 10 * np.log10(np.mean(y[1000:N_ORACLE - 1000] ** 2) / np.mean(z[1000:-1000] ** 2))
    log(f"surface: SSBDemod rejection of the other band {rej:.2f} dB (bar 65)")
    if not rej >= 65.0:
        raise AssertionError("surface: SSBDemod does not reject the other band")
    times["SSBDemod"] = _op_times(liquiddsp.SSBDemod("usb"), blocks(xu, N_SURFACE))
    y = np.concatenate(_run_path("Delay", liquiddsp.Delay(25), blocks(xn, N_SURFACE), {}))
    exact = np.array_equal(lo.DelayOracle(25, complex_data=True)(xn[:N_ORACLE]),
                           y[:N_ORACLE])
    log(f"surface: Delay(25) equal to its oracle n={N_ORACLE}: {exact}")
    if not exact:
        raise AssertionError("surface: Delay differs from its oracle")
    times["Delay"] = _op_times(liquiddsp.Delay(25), blocks(xn, N_SURFACE))
    h = firdes.halfband_lowpass(5, 60.0)
    y = np.concatenate(_run_path("HilbertTransform interp", liquiddsp.HilbertTransform(),
                                 blocks(xn, N_SURFACE), {}))
    _score(f"HilbertTransform interp vs float64 n={N_ORACLE}",
           hilbert_f64(h, xn[:N_ORACLE], True), y[:2 * N_ORACLE], 120.0)
    times["HilbertTransform interp"] = _op_times(liquiddsp.HilbertTransform(),
                                                 blocks(xn, N_SURFACE))
    xr = np.ascontiguousarray(xn.real)
    y = np.concatenate(_run_path("HilbertTransform decim", liquiddsp.HilbertTransform(),
                                 blocks(xr, N_SURFACE), {}))
    _score(f"HilbertTransform decim vs float64 n={N_ORACLE}",
           hilbert_f64(h, xr[:N_ORACLE], False), y[:N_ORACLE // 2], 120.0)
    times["HilbertTransform decim"] = _op_times(liquiddsp.HilbertTransform(),
                                                blocks(xr, N_SURFACE))
    for name, (med, spread) in times.items():
        log(f"timing: {name} call: median {med * 1e3:.3f} ms of 5 (spread {spread * 100:.1f}%)")
    # where a call's time goes, for the classes that launch the new kernels
    for name, op, bl in (
            ("CLowpassIIR scan", liquiddsp.CLowpassIIR(order=8, Fc=0.0075, mode="scan"),
             blocks(x, N_SURFACE)),
            ("BroadcastAM", liquiddsp.BroadcastAM(), blocks(xb, N_CALLBACK_OUT)),
            ("FMStereo", liquiddsp.FMStereo(600_000.0, 48_000.0), blocks(xs, N_SURFACE))):
        log(f"timing: {name} call, profiler window: {json.dumps(profile_block(op, bl))}")


# --------------------------------------------------------------------------
# The receiver chains beyond the AM receiver, at the full widths of
# bench.py's configs 2 and 3 (bench.py:451-504): the 16-channel FM bank
# on 8M-sample blocks in c64 / i16 / u8, a mixed fm / coherent am / usb /
# lsb bank over the same channels, WBFM mono and stereo on 2M-sample
# blocks, and SSBReceiver on 1M-sample blocks, chunked and exact.
N_BANK = 8_000_000
N_WBFM = 2_000_000
N_SSB = 1_000_000
BANK_FREQS = tuple(float(f) for f in np.linspace(-1e6, 1e6, 16, endpoint=False))
MIXED = ("fm", "am", "usb", "lsb") * 4
FM_DEV = 10_000.0          # the test carriers' peak deviation (Hz)
AM_OFFSET, USB_TONE, LSB_TONE = 20.0, 1200.0, 900.0   # Hz off the channel centre


@contextlib.contextmanager
def recording(module, name: str, keep: int):
    """While on, module.<name> keeps the arguments and output of its first
    ``keep`` calls in the yielded list (as (args, output)); it computes
    what it did."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args):
        out = fn(*args)
        if len(calls) < keep:
            calls.append((args, out))
        return out
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def bank_signal(n: int, demods, seed: int, amp: float = 0.05):
    """One carrier per BANK_FREQS channel, made in float64 on the card:
    FM (FM_DEV, a tone of 400 + 150 k Hz) for 'fm', 50% AM of a 1 kHz tone
    AM_OFFSET off centre for 'am', a tone USB_TONE above or LSB_TONE below
    the centre for 'usb' / 'lsb'. Returns complex128 (n,)."""
    import torch
    rng = np.random.default_rng(seed)
    t = torch.arange(n, dtype=torch.float64, device=DEV)
    x = torch.zeros(n, dtype=torch.complex128, device=DEV)
    w = lambda f: 2 * np.pi * f / 2.4e6
    for k, (fc, d) in enumerate(zip(BANK_FREQS, demods)):
        ph0 = float(rng.uniform(0, 2 * np.pi))
        env = torch.full_like(t, amp)
        if d == "fm":
            fm_hz = 400.0 + 150.0 * k
            ph = w(fc) * t + FM_DEV / fm_hz * torch.sin(w(fm_hz) * t)
        elif d == "am":
            ph = w(fc + AM_OFFSET) * t
            env = amp * (1.0 + 0.5 * torch.sin(w(1000.0) * t))
        else:
            ph = w(fc + (USB_TONE if d == "usb" else -LSB_TONE)) * t
        x += torch.polar(env, ph + ph0)
    return x


def wire_of(x):
    """A complex128 stream on the card as c64, raw i16 and u8 (n, 2), and
    the c64 of the i16 and u8 values."""
    import torch
    v = torch.view_as_real(x.to(torch.complex64))
    i16 = torch.round(v * 32767).clamp(-32767, 32767).to(torch.int16)
    u8 = torch.round(v * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)
    c = lambda p: torch.complex(p[:, 0], p[:, 1])
    return {"c64": x.to(torch.complex64), "i16": i16, "u8": u8,
            "c64_i16": c(i16.float() / 32767), "c64_u8": c((u8.float() - 127.5) / 127.5)}


def _split(x, block: int):
    return [x[k * block:(k + 1) * block] for k in range(x.shape[0] // block)]


def bank_oracle_f64(rx, iq, channels):
    """tests/oracle/bank_oracle.fm_bank_f64 for a bank's FM ``channels``,
    with the bank's designs in float64, on the host."""
    from tpudsp_torch.design import firdes, iirdes
    cfg = rx.cfg
    return oracle_module("bank_oracle").fm_bank_f64(
        iq.cpu().numpy(), rx.params.dtheta.cpu().numpy()[list(channels)],
        firdes.kaiser_lowpass(cfg.taps1, 0.45 / cfg.decim1, 60.0),
        firdes.kaiser_lowpass(cfg.taps2, 0.45 / cfg.decim2, 60.0), cfg.decim1, cfg.decim2,
        cfg.kd, *iirdes.deemphasis_coeffs(cfg.audio_rate))


def _run_chain(path: str, rx, blocks, per_block: dict, records=(), phase: str = "receivers"):
    """rx over blocks on the card, its launches counted (the counts set to
    0 just before, read just after) and held to per_block x len(blocks);
    ``records``: (module, name, keep) to record during the run. Returns
    (the outputs, the recorded calls)."""
    import torch
    with contextlib.ExitStack() as stack:
        rec = [stack.enter_context(recording(*r)) for r in records]
        torch.cuda.synchronize()
        zero_counts()                                  # the path starts
        outs = [rx(b) for b in blocks]
        torch.cuda.synchronize()
        expect_counts(f"{phase} {path}", read_counts(),   # ... and ends
                      {k: len(blocks) * v for k, v in per_block.items()})
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"{phase} {path}: output not finite")
    return outs, rec


def _check(what: str, value: float, bar: float, phase: str = "receivers"):
    log(f"{phase}: {what}: {value:.2f} (bar {bar:g})")
    if not value > bar:
        raise AssertionError(f"{phase}: {what} {value:.2f}, bar {bar:g}")


def _conv_front(x, halo, Tre, Tim, D1, nj):
    """The JAX package's CPU form of the bank front on [halo | x]: one
    strided conv1d (kernels/decimate.strided_cfir_conv*, TF32 off)."""
    import torch
    from tpudsp_torch.kernels import decimate as kdec
    f = {torch.complex64: kdec.strided_cfir_conv, torch.int16: kdec.strided_cfir_conv_i16,
         torch.uint8: kdec.strided_cfir_conv_u8}[x.dtype]
    return f(torch.cat([halo, x]), Tre, Tim, D1, nj)


def _hold_front(path: str, calls):
    """Each recorded halo_async launch of the bank front (cuda/halo_async.
    cfir: block 0's, whose halo is the initial fill, and block 1's, whose
    halo is block 0's tail) against its plain version cfir_ref and against
    the conv form on the same CUDA tensors: >= 110 dB each."""
    from tpudsp_torch.cuda import halo_async
    for k, ((x, halo, Tre, Tim, D1, nj), y) in enumerate(calls):
        y = y.cpu().numpy()
        for name, ref in (("plain cfir_ref", halo_async.cfir_ref(x, halo, Tre, Tim, D1, nj)),
                          ("conv form", _conv_front(x, halo, Tre, Tim, D1, nj))):
            _check(f"{path} block {k} halo_async vs {name} C={Tre.shape[0]} nj={nj} "
                   f"{x.dtype} SNR dB", snr_db(ref.cpu().numpy(), y), 110.0)


def _hold_first_order(path: str, calls):
    """Each recorded first_order_apply_blocked call against kernels/iir's
    plain version, bit for bit."""
    from tpudsp_torch.kernels import iir as kiir
    for k, (args, (last, y)) in enumerate(calls):
        r_last, r_y = kiir.first_order_apply_blocked(*args)
        _compare_exact(f"{path} first_order_scan call {k} rows {tuple(y.shape)}",
                       (y, last), (r_y, r_last))


def _pure_tone_hz(a, fs: float = 48_000.0) -> float:
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    return float(np.fft.rfftfreq(len(a), 1 / fs)[np.argmax(spec[3:]) + 3])


# bank16's hand-kernel launches a block, and all its kernels a block in a
# profiler window (bank16_traced_launches)
BANK16_PER_BLOCK = {"halo_async": 1, "bank_rotate": 1, "first_order_scan": 1}
BANK16_LAUNCHES = 10


def _hold_bank_rotate(path: str, calls):
    """Each recorded bank_rotate launch (cuda/bank_rotate.fm_base) against
    its plain version kernels/bank_rotate.fm_base on the same CUDA tensors,
    bit for bit."""
    from tpudsp_torch.kernels import bank_rotate as kbr
    for k, (args, out) in enumerate(calls):
        _compare_exact(f"{path} block {k} bank_rotate {tuple(out[0].shape)}", out,
                       kbr.fm_base(*args))


def receivers_bank16(timings):
    """bench.py's bank16 (16 FM channels, linspace(-1e6, 1e6, 16), 2.4
    Msps) on three 8M-sample blocks in c64, i16 and u8."""
    import torch
    from tpudsp_torch.chains import BankConfig, ReceiverBank
    from tpudsp_torch.cuda import bank_rotate, first_order, halo_async
    cfg = BankConfig(freqs=BANK_FREQS)
    x = bank_signal(3 * N_BANK, ("fm",) * 16, seed=20)
    wire = {k: _split(v, N_BANK) for k, v in wire_of(x).items()}
    outs, rxs = {}, {}
    for fmt in ("c64", "i16", "u8", "c64_i16", "c64_u8"):
        rx = rxs[fmt] = ReceiverBank(cfg, N_BANK, input_format=fmt[:3], device=DEV)
        outs[fmt], (front, rot, tails) = _run_chain(
            f"bank16 {fmt}", rx, wire[fmt], BANK16_PER_BLOCK,
            [(halo_async, "cfir", 2), (bank_rotate, "fm_base", 2),
             (first_order, "first_order_apply_blocked", 1)])
        if fmt in ("c64", "i16", "u8"):
            _hold_front(f"bank16 {fmt}", front)
            _hold_bank_rotate(f"bank16 {fmt}", rot)
            _hold_first_order(f"bank16 {fmt}", tails)
            timings[f"bank16 {fmt}"] = (rx, wire[fmt], N_BANK)
        if fmt == "c64":
            results["bank_front"] = front[0][0]
    y = {k: torch.cat(v, 1).cpu().numpy() for k, v in outs.items()}
    m = N_BANK // 50
    ref = bank_oracle_f64(rxs["c64"], wire["c64"][0], range(16))
    worst = min(snr_db(ref[c, 50:], y["c64"][c, 50:m]) for c in range(16))
    _check("bank16 c64 block 0 vs float64 FM-bank oracle, worst channel, dB", worst, 100.0)
    _check("bank16 i16 vs c64 of the i16 values, 3 blocks, dB", snr_db(y["c64_i16"], y["i16"]), 90.0)
    _check("bank16 u8 vs c64 of the u8 values, block 0 past 32, dB",
           snr_db(y["c64_u8"][:, 32:m], y["u8"][:, 32:m]), 60.0)
    _check("bank16 u8 vs c64 of the u8 values, blocks 1-2, dB",
           snr_db(y["c64_u8"][:, m:], y["u8"][:, m:]), 85.0)
    one = ReceiverBank(cfg, 2 * N_BANK, device=DEV)(x[:2 * N_BANK].to(torch.complex64)).cpu().numpy()
    _check("bank16 two 8M blocks vs one 16M block, dB", snr_db(one[:, 10:], y["c64"][:, 10:2 * m]),
           60.0)
    bank16_traced_launches(rxs["c64"], wire["c64"])


def bank16_traced_launches(rx, blocks, tries: int = 3):
    """bank16's launches a block as torch.profiler sees them, as the
    benchmark's traced window counts them: one block opens the window, then
    the kernels of the others (copies and sets not counted), BANK16_LAUNCHES
    a block; the front's cfir_kernel and the rotation's bank_rotate_kernel
    once a block, as halo_async's and bank_rotate's launch counters say. A
    window whose trace holds fewer hand kernels than the counters (the
    profiler can drop a block's device events) is traced again, up to
    ``tries`` windows, as the benchmark's traced window is."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from tpudsp_torch.cuda import bank_rotate, halo_async
    counters = {"cfir_kernel": halo_async._launch, "bank_rotate_kernel": bank_rotate._launch}
    nb = len(blocks) - 1
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rx(blocks[0])
            torch.cuda.synchronize()
            n0 = {k: c.launches for k, c in counters.items()}
            with record_function("smoke.window"):
                for b in blocks[1:]:
                    rx(b)
                torch.cuda.synchronize()
        counted = {k: c.launches - n0[k] for k, c in counters.items()}
        events = list(prof.events())
        host = {e.name for e in events if e.device_type != DeviceType.CUDA}
        t0 = next(e for e in events if e.name == "smoke.window").time_range.start
        kernels = [e.name for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in host
                   and e.time_range.start >= t0 and not e.name.startswith(("Memcpy", "Memset"))]
        traced = {k: sum(1 for n in kernels
                         if re.search(rf"(?<![A-Za-z0-9_]){k}(?![A-Za-z0-9_])", n))
                  for k in counters}
        log(f"receivers: bank16 c64 traced over {nb} blocks (window {attempt + 1}): "
            f"{len(kernels) / nb:g} kernels a block (expected {BANK16_LAUNCHES}); in the "
            f"trace {traced}, by the counters {counted}")
        if traced == counted:
            break
    if not traced == counted == {k: nb for k in counters}:
        raise AssertionError(f"receivers: bank16 hand kernels {traced} in the trace, "
                             f"{counted} counted, {nb} blocks")
    if len(kernels) != BANK16_LAUNCHES * nb:
        raise AssertionError(f"receivers: bank16 {len(kernels) / nb:g} kernels a block, "
                             f"not {BANK16_LAUNCHES}")


def receivers_mixed(timings):
    """The 16 channels as fm / coherent am / usb / lsb in turn
    (am_coherent=True, backend 'kernel'), three 8M-sample c64 blocks."""
    import torch
    from tpudsp_torch.chains import BankConfig, ReceiverBank
    from tpudsp_torch.chains import bank as cbank
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.cuda import first_order, halo_async
    from tpudsp_torch.kernels import warmup as kwarm
    cfg = BankConfig(freqs=BANK_FREQS, demod=MIXED, am_coherent=True)
    x = bank_signal(3 * N_BANK, MIXED, seed=21)
    blocks = _split(x.to(torch.complex64), N_BANK)
    rx = ReceiverBank(cfg, N_BANK, device=DEV)
    # the AM channels' front: one launch over the 4 streams, and one more
    # for the exact re-run of each stream's zero-padded last chunk when the
    # chunk does not divide the channel-rate block (800,000 = 781 x 1024 + 256)
    L = N_BANK // cfg.decim1
    front_launches = 1 + bool(L % cbank.KERNEL_CHUNK)
    outs, (front, tails, am) = _run_chain(
        "mixed", rx, blocks,
        {"halo_async": 1, "first_order_scan": 2, "am_front_scan": front_launches},
        [(halo_async, "cfir", 2), (first_order, "first_order_apply_blocked", 2),
         (cbank, "front_chunked", 1)])
    _hold_front("mixed", front)
    _hold_first_order("mixed", tails)
    p, st, xa, chunk, warmup = am[0][0]
    if chunk != cbank.KERNEL_CHUNK or warmup != kwarm.warmup_for(agc_alpha=0.01, pll_bw=0.001):
        raise AssertionError(f"mixed: AM front chunk {chunk} warmup {warmup}")
    _compare(f"mixed am_front_scan C={xa.shape[0]} L={xa.shape[1]} chunk {chunk} warmup {warmup}",
             am[0][1], scan.front_chunked_ref(p, st, xa, chunk, warmup))
    timings["mixed c64"] = (rx, blocks, N_BANK)
    y = torch.cat(outs, 1).cpu().numpy()
    m = N_BANK // 50
    fm_ch = [k for k, d in enumerate(MIXED) if d == "fm"]
    ref = bank_oracle_f64(rx, blocks[0], fm_ch)
    worst = min(snr_db(ref[i, 50:], y[c, 50:m]) for i, c in enumerate(fm_ch))
    _check("mixed FM channels, block 0 vs float64 FM-bank oracle, worst channel, dB", worst, 100.0)
    last = y[:, 2 * m:]
    for k, d in enumerate(MIXED):
        if d == "am" and not abs(last[k].mean()) < 0.05 * np.abs(last[k]).max():
            raise AssertionError(f"mixed: AM channel {k} has a DC of {last[k].mean():.4f}")
        tone = {"am": 1000.0, "usb": USB_TONE, "lsb": LSB_TONE}.get(d)
        if tone and abs(_pure_tone_hz(last[k] - last[k].mean()) - tone) > 40.0:
            raise AssertionError(f"mixed: channel {k} ({d}) does not carry its {tone} Hz tone")
    log("receivers: mixed AM channels DC-free, AM / USB / LSB channels on their tones")
    one = ReceiverBank(cfg, 2 * N_BANK, device=DEV)(torch.cat(blocks[:2])).cpu().numpy()
    _check("mixed two 8M blocks vs one 16M block, dB", snr_db(one[:, 10:], y[:, 10:2 * m]), 60.0)


def receivers_wbfm(timings):
    """WBFM mono and stereo on three 2M-sample blocks (bench.py's n2):
    mono vs the float64 FM-bank oracle; stereo in c64 / i16 / u8, its
    separation and wire formats."""
    import torch
    from tpudsp_torch.chains import WBFMStereoReceiver, mono_receiver
    from tpudsp_torch.cuda import bank_rotate, first_order, halo_async
    from tpudsp_torch.kernels import iir as kiir
    from tpudsp_torch.kernels import pll as kpll
    t = torch.arange(3 * N_WBFM, dtype=torch.float64, device=DEV)
    w = lambda f: 2 * np.pi * f / 2.4e6
    xm = torch.polar(torch.full_like(t, 0.7),
                     w(100e3) * t + 75e3 / 1000.0 * torch.sin(w(1000.0) * t)).to(torch.complex64)
    rx = mono_receiver(100e3, block_len=N_WBFM, device=DEV)
    outs, (front, rot, tails) = _run_chain(
        "wbfm mono", rx, _split(xm, N_WBFM),
        {"halo_async": 1, "bank_rotate": 1, "first_order_scan": 1},
        [(halo_async, "cfir", 2), (bank_rotate, "fm_base", 2),
         (first_order, "first_order_apply_blocked", 1)])
    _hold_front("wbfm mono", front)
    _hold_bank_rotate("wbfm mono", rot)
    _hold_first_order("wbfm mono", tails)
    timings["wbfm mono c64"] = (rx, _split(xm, N_WBFM), N_WBFM)
    ref = bank_oracle_f64(rx, xm, [0])
    _check("wbfm mono 3 blocks vs float64 FM-bank oracle, dB",
           snr_db(ref[:, 50:], torch.cat(outs, 1).cpu().numpy()[:, 50:]), 100.0)
    # stereo: tests/test_chains.py:141-160's composite, L 900 Hz, R 2500 Hz
    fm = oracle_module("fm_stereo_checks")
    n = 3 * N_WBFM
    tone = lambda f: np.sin(2 * np.pi * f / 2.4e6 * np.arange(n))
    xs = torch.from_numpy(fm.stereo_composite(n, tone(900.0), tone(2500.0), 2.4e6, 0.008)).to(DEV)
    wire = {k: _split(v, N_WBFM) for k, v in wire_of(xs.to(torch.complex128)).items()}
    ys = {}
    for fmt in ("c64", "i16", "u8", "c64_i16", "c64_u8"):
        rx = WBFMStereoReceiver(block_len=N_WBFM, input_format=fmt[:3], device=DEV)
        outs, (tails, poles) = _run_chain(
            f"wbfm stereo {fmt}", rx, wire[fmt],
            {"first_order_scan": 1, "first_order_scan_c64": 2},
            [(first_order, "first_order_apply_blocked", 1), (kpll, "_onepole_scan", 2)])
        ys[fmt] = torch.cat(outs).cpu().numpy()
        if fmt in ("c64", "i16", "u8"):
            _hold_first_order(f"wbfm stereo {fmt}", tails)
            for k, ((rho, carry, v), y) in enumerate(poles):
                _compare_exact(f"wbfm stereo {fmt} pilot smoother {k} n={v.shape[0]}", (y,),
                               (kiir.first_order_apply_blocked_c64(1.0 - rho, rho, carry, v)[1],))
            timings[f"wbfm stereo {fmt}"] = (rx, wire[fmt], N_WBFM)
    sep_l, sep_r = fm.separation_db(ys["c64"], 900.0, 2500.0)
    _check("wbfm stereo c64 separation L (900 Hz over 2500 Hz), dB", sep_l, 30.0)
    _check("wbfm stereo c64 separation R (2500 Hz over 900 Hz), dB", sep_r, 30.0)
    for fmt in ("i16", "u8"):
        s0 = len(ys["c64"]) // 10
        _check(f"wbfm stereo {fmt} vs c64 of its values past the first tenth, dB",
               snr_db(ys[f"c64_{fmt}"][s0:], ys[fmt][s0:]), 80.0)
    one = WBFMStereoReceiver(block_len=2 * N_WBFM, device=DEV)(torch.cat(wire["c64"][:2])).cpu().numpy()
    _check("wbfm stereo two 2M blocks vs one 4M block, dB",
           snr_db(one[200:], ys["c64"][200:len(one)]), 60.0)


def receivers_ssb(timings):
    """SSBReceiver() (2 Msps, 48 kHz pcm) on three 1M-sample blocks of a
    USB voice signal, chunked and exact; the LSB receiver rejects it."""
    import scipy.signal as sig
    import torch
    from tpudsp_torch.chains import SSBConfig, SSBReceiver
    from tpudsp_torch.cuda import agc_scan
    from tpudsp_torch.kernels import agc as kagc
    from tpudsp_torch.kernels import warmup as kwarm
    n = 3 * N_SSB
    t = np.arange(n)
    m = np.sin(2 * np.pi * 800.0 / 2e6 * t) + 0.5 * np.sin(2 * np.pi * 1900.0 / 2e6 * t)
    x = torch.from_numpy((0.3 * sig.hilbert(m) / 2).astype(np.complex64)).to(DEV)
    blocks = _split(x, N_SSB)
    w = kwarm.warmup_for(agc_alpha=0.01)
    chunk = kwarm.chunk_for(w)
    n_out = N_SSB * 48 // 2000
    ys = {}
    for exact in (False, True):
        name = "exact" if exact else "chunked"
        rx = SSBReceiver(SSBConfig(), N_SSB, exact=exact, device=DEV)
        # chunked: one launch over the lanes, one exact re-run of the
        # padded last chunk's warmup and tail (24,000 = 6 x 3840 + 960)
        launches = 1 if exact else 1 + bool(n_out % chunk)
        outs, (agc,) = _run_chain(f"ssb {name}", rx, blocks, {"agc_scan": launches},
                                  [(agc_scan, "agc_exact" if exact else "agc_chunked", 1)])
        args, out = agc[0]
        ref = kagc.agc_apply(*args) if exact else kagc.agc_apply_chunked(*args)
        _compare(f"ssb {name} agc_scan L={args[2].shape[1]}", out, ref)
        ys[name] = torch.cat(outs).cpu().numpy()
        timings[f"ssb {name}"] = (rx, blocks, N_SSB)
    lsb = SSBReceiver(SSBConfig(band="lsb"), N_SSB, device=DEV)
    y_lsb = torch.cat([lsb(b) for b in blocks]).cpu().numpy()
    h = len(y_lsb) // 2
    for name, y in ys.items():
        _check(f"ssb {name}: USB voice, usb over lsb receiver power (settled half), dB",
               10 * np.log10(np.mean(y[h:] ** 2) / np.mean(y_lsb[h:] ** 2)), 30.0)
    _check("ssb chunked vs exact (settled half), dB", snr_db(ys["exact"][h:], ys["chunked"][h:]),
           60.0)
    one = SSBReceiver(SSBConfig(), 2 * N_SSB, device=DEV)(torch.cat(blocks[:2])).cpu().numpy()
    _check("ssb chunked two 1M blocks vs one 2M block (past the first 1000), dB",
           snr_db(one[1000:], ys["chunked"][1000:len(one)]), 60.0)


def time_receivers(timings):
    """Each path's block time (medians of 5 after a warm-up block, host
    clock with a synchronise and CUDA events), samples/s per card, and one
    profiler window over a block (profile_block)."""
    out = {}
    for path, (rx, blocks, n) in timings.items():
        cyc = (blocks * 2)[:6]
        med, spread = _block_times(rx, cyc)
        dev_ms = _block_device_ms(rx, cyc)
        prof = profile_block(rx, cyc)
        out[path] = {"host_ms": med * 1e3, "host_spread": spread, "cuda_event_ms": dev_ms,
                     "samples_per_s": n / med, "profile": prof}
        log(f"timing: {path} {n}-sample block: median {med * 1e3:.3f} ms of 5 (spread "
            f"{spread * 100:.1f}%), CUDA events median {dev_ms:.3f} ms, "
            f"{n / med / 1e6:.1f} Msamp/s; profiler window: {json.dumps(prof)}")
    return out


def tap_count(Tre, Tim) -> int:
    """The taps the function has: the (channel, k, d) positions of the
    blocked (C, Kc, D1) taps where Tre or Tim is not zero (the blocked
    layout pads each channel's taps with zeros to whole frames)."""
    nz = Tre != 0 if Tim is None else (Tre != 0) | (Tim != 0)
    return int(nz.sum())


def time_bank_front(case):
    """The bank front at bank16's 8M-sample c64 shape (16 channels of 128
    complex taps, blocked 13 x 10, 800,000 outputs) by CUDA events: the
    kernel (cuda/halo_async.cfir), one strided conv1d and the wide f32
    matmul (TF32 off; both on [halo | x], the concatenation timed with
    them); and halo_async's bound there."""
    import torch
    from tpudsp_torch.cuda import halo_async
    from tpudsp_torch.kernels import decimate as kdec
    x, halo, Tre, Tim, D1, nj = case
    forms = {"kernel": lambda: halo_async.cfir(x, halo, Tre, Tim, D1, nj),
             "conv": lambda: _conv_front(x, halo, Tre, Tim, D1, nj),
             "wide": lambda: kdec.strided_cfir_matmul_wide(torch.cat([halo, x]), Tre, Tim, D1, nj)}
    out = {name: _cuda_ms(f, 10) for name, f in forms.items()}
    C, taps = Tre.shape[0], tap_count(Tre, Tim)
    nbytes = (x.numel() + halo.numel()) * x.element_size() + taps * 8 + nj * C * 8
    out["taps"] = taps
    out["bound_ms"] = max(nbytes / HBM_BPS, 8.0 * taps * nj / F32_FLOPS) * 1e3
    log(f"timing: bank16 front end, 8M c64 samples, C={C} taps {taps} nj={nj}: kernel "
        f"{out['kernel']:.4f} ms, conv {out['conv']:.4f} ms, wide {out['wide']:.4f} ms, "
        f"bound {out['bound_ms']:.4f} ms")
    return out


def phase_receivers():
    """The bank, WBFM and SSB chains at full width: each kernel of their
    paths held against its plain version on the card, each chain against
    the float64 FM-bank oracle and the JAX package's functional pins, the
    launches per block asserted, and each path's block time."""
    timings: dict = {}
    receivers_bank16(timings)
    receivers_mixed(timings)
    receivers_wbfm(timings)
    receivers_ssb(timings)
    res = time_receivers(timings)
    res["bank16 front ms"] = time_bank_front(results.pop("bank_front"))
    res["bank16 bank_rotate"] = time_bank_rotate()
    log(f"timing: receivers: {json.dumps(res)}")


# BASELINE config 4 (bench.py:506-539): ChannelizedBankConfig(), 1024
# channels of 12 taps a branch at 100 Msps, blocks of 1024 x 16384 samples
N_PFB = 1024 * 16384
PFB_FS = 100e6
# the carriers' channels: 12 FM (even) and 4 AM (odd); an empty channel
# holds only the prototype's stopband leakage, 60-90 dB below a carrier, so
# the 16 channels held against the float64 oracle are these
PFB_FM = (2, 100, 160, 256, 400, 480, 600, 776, 830, 900, 990, 1020)
PFB_AM = (51, 333, 513, 701)
PFB_DEV = 20_000.0          # the FM carriers' peak deviation (Hz)
PFB_AM_TONES = (1000.0, 2500.0)
N_PFB_ORACLE = 1 << 22      # the block's prefix held against the float64 oracle
PFB_SETTLE = 256            # frames of block 0 left out: the u8 tail starts at 127, not 127.5


def pfb_signal(nblocks: int, seed: int, amp: float = 0.05):
    """PFB_FM's FM carriers (PFB_DEV, a tone of 300 + 100 k Hz) and
    PFB_AM's 50% AM carriers (PFB_AM_TONES in turn, 15 Hz off the channel
    centre), each at ``amp``, made in float64 on the card at 100 Msps over
    ``nblocks`` blocks of N_PFB. Returns complex128."""
    import torch
    rng = np.random.default_rng(seed)
    t = torch.arange(nblocks * N_PFB, dtype=torch.float64, device=DEV)
    x = torch.zeros(t.shape[0], dtype=torch.complex128, device=DEV)
    w = lambda f: 2 * np.pi * f / PFB_FS
    for k, c in enumerate(PFB_FM):
        fm_hz = 300.0 + 100.0 * k
        ph = 2 * np.pi * c / 1024 * t + PFB_DEV / fm_hz * torch.sin(w(fm_hz) * t)
        x += torch.polar(torch.full_like(t, amp), ph + float(rng.uniform(0, 2 * np.pi)))
    for k, c in enumerate(PFB_AM):
        env = amp * (1.0 + 0.5 * torch.sin(w(PFB_AM_TONES[k % 2]) * t))
        x += torch.polar(env, (2 * np.pi * c / 1024 + w(15.0)) * t
                         + float(rng.uniform(0, 2 * np.pi)))
    return x


def _wire_noise(n: int, fmt: str, seed: int):
    """n random wire samples of ``fmt`` on the card: complex64 noise, or
    raw (n, 2) int16 / uint8 over their whole range."""
    import torch
    rng = np.random.default_rng(seed)
    if fmt == "c64":
        v = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
        return torch.from_numpy(v.astype(np.complex64)).to(DEV)
    lo, hi, dt = (-32767, 32768, np.int16) if fmt == "i16" else (0, 256, np.uint8)
    return torch.from_numpy(rng.integers(lo, hi, (n, 2)).astype(dt)).to(DEV)


def kernel_pfb():
    """pfb_branch bit for bit against kernels/pfb.branch_accumulate on the
    card at config 4's width (C = 1024): at its taps (T = 12) and at
    random taps of T = 8 and 6 (the kernel's instance for up to 8 taps,
    the taps past T masked), the 16.8M-sample block behind a random tail
    (c64, i16, u8; os 1 and 2: each branch's 16,384 or 32,768 frames cut
    into runs of frames, the last one short), blocks of one frame, of whole
    frames around the tail's length htail = T C - 1 ((T - 1) C, T C, (T +
    1) C), of fewer frames than a run takes at the full block (100), and a
    second block fed from the first block's tail; and a T of 17 refused."""
    import torch
    from tpudsp_torch.chains import channelizer as tch
    from tpudsp_torch.cuda import pfb
    from tpudsp_torch.kernels import pfb as kpfb
    cfg = tch.ChannelizerConfig()
    C = cfg.nchan
    wire = wire_of(pfb_signal(1, seed=30))
    rng = np.random.default_rng(33)
    for T in (cfg.taps_per_branch, 8, 6):
        htail = (T - 1) * C + C - 1
        for k, fmt in enumerate(("c64", "i16", "u8")):
            Ht, _ = tch.build(tch.ChannelizerConfig(taps_per_branch=T), fmt, device=DEV)
            if T != cfg.taps_per_branch:
                Ht = torch.from_numpy(rng.standard_normal((T, C)).astype(np.float32)
                                      / (T * C)).to(DEV)
            tail = _wire_noise(htail, fmt, 40 + k)
            x = wire[fmt]
            for os_ in (1, 2):
                ku = pfb.branch_accumulate(Ht, tail, x, os_)
                ru, plain_ms = timed(lambda: kpfb.branch_accumulate(Ht, tail, x, os_))
                err = _compare_exact(f"pfb_branch config 4 T={T} {fmt} os={os_} N={N_PFB} "
                                     f"M={ku.shape[0]}", (ku,), (ru,))
                if T == cfg.taps_per_branch and fmt == "c64" and os_ == 1:
                    _record("pfb_branch", err, plain_ms)
                del ku, ru
                for n in (C, (T - 1) * C, T * C, (T + 1) * C, 100 * C):
                    xe = x[-n:].contiguous()
                    _compare_exact(f"pfb_branch T={T} {fmt} os={os_} N={n}",
                                   (pfb.branch_accumulate(Ht, tail, xe, os_),),
                                   (kpfb.branch_accumulate(Ht, tail, xe, os_),))
                # the second block behind the first one's tail (x, then 3 frames)
                tail2 = torch.cat([tail, x[-htail:]])[-htail:]
                x2 = _wire_noise(3 * C, fmt, 50 + k)
                _compare_exact(f"pfb_branch T={T} {fmt} os={os_} second block N={3 * C}",
                               (pfb.branch_accumulate(Ht, tail2, x2, os_),),
                               (kpfb.branch_accumulate(Ht, tail2, x2, os_),))
    H17 = torch.zeros((17, C), device=DEV)
    try:
        pfb.branch_accumulate(H17, torch.zeros(17 * C - 1, dtype=torch.complex64, device=DEV),
                              wire["c64"][:C].contiguous(), 1)
    except ValueError as e:
        log(f"kernel[pfb_branch T=17]: refused: {e}")
    else:
        raise AssertionError("pfb_branch took 17 taps a branch")


def kernel_first_order_mc():
    """The column carry (cuda/first_order.first_order_apply_blocked_mc: one
    first_order_scan_cols launch, reading the columns in place and writing
    the rows) bit for bit against kernels/iir.first_order_apply_blocked_mc
    on the card: config 4's de-emphasis down (16384, 1024) frames from
    random carries, the first 1, 31, 33 frames and the column tile's edges
    (COLS_TILE_BLOCKS x 32 = 1024: 1023, 1024, 1025, 2049), 16385 frames,
    1022 and 1021 of the columns (no multiple of the 8 a block takes),
    infinite and NaN samples, and two chained calls."""
    import torch
    from tpudsp_torch.chains import channelizer as tch
    from tpudsp_torch.cuda import first_order as fo
    from tpudsp_torch.design import iirdes
    from tpudsp_torch.kernels import iir as kiir
    b0, a = iirdes.deemphasis_coeffs(tch.ChannelizerConfig().chan_rate)
    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.standard_normal((16385, 1024)).astype(np.float32)).to(DEV)
    y0 = torch.from_numpy(rng.standard_normal(1024).astype(np.float32)).to(DEV)
    main = x[:16384].contiguous()
    k = fo.first_order_apply_blocked_mc(b0, a, y0, main)
    ref, plain_ms = timed(lambda: kiir.first_order_apply_blocked_mc(b0, a, y0, main))
    err = _compare_exact("first_order_scan columns (16384, 1024)", k, ref)
    _record("first_order_scan_mc", err, plain_ms)
    tile = kiir.COLS_TILE_BLOCKS * kiir.L_BLOCK
    for n in (1, 31, 33, tile - 1, tile, tile + 1, 2 * tile + 1, 16385):
        xe = x[:n].contiguous()
        _compare_exact(f"first_order_scan columns ({n}, 1024)",
                       fo.first_order_apply_blocked_mc(b0, a, y0, xe),
                       kiir.first_order_apply_blocked_mc(b0, a, y0, xe))
    for n, c in ((16384, 1022), (tile + 1, 1021), (33, 1021)):
        xe = x[:n, :c].contiguous()
        _compare_exact(f"first_order_scan columns ({n}, {c})",
                       fo.first_order_apply_blocked_mc(b0, a, y0[:c], xe),
                       kiir.first_order_apply_blocked_mc(b0, a, y0[:c], xe))
    # infinite and NaN samples: NaN from them on in their columns
    xn = x[:3000].clone()
    xn[40, 1], xn[37, 2], xn[1100, 0], xn[2047, 1023] = (float("inf"), float("-inf"),
                                                         float("nan"), float("nan"))
    _compare_exact("first_order_scan columns (3000, 1024) with inf and NaN samples",
                   fo.first_order_apply_blocked_mc(b0, a, y0, xn),
                   kiir.first_order_apply_blocked_mc(b0, a, y0, xn))
    k1 = fo.first_order_apply_blocked_mc(b0, a, y0, x[:5000].contiguous())
    k2 = fo.first_order_apply_blocked_mc(b0, a, k1[0], x[5000:].contiguous())
    r1 = kiir.first_order_apply_blocked_mc(b0, a, y0, x[:5000])
    r2 = kiir.first_order_apply_blocked_mc(b0, a, r1[0], x[5000:])
    _compare_exact("first_order_scan columns two chained calls (5000 + 11385, 1024)",
                   k1 + k2, r1 + r2)


def kernel_fm_deemph_cols():
    """The FM bank's fused launch (cuda/first_order.fm_deemph_cols: one
    launch of the column kernel's FM instance, from the (M, C) complex64
    channel matrix to the (C, M) audio rows) bit for bit against
    kernels/iir.fm_deemph_cols on the card: config 4's (16384, 1024) from
    random carries, the first 1, 31, 33 frames and the tile's edges
    (1023, 1024, 1025, 2049), 16385 frames, 1022 and 1021 of the channels
    (no multiple of the 8 a block takes), zero, infinite and NaN frames,
    and three chained calls (the second of one frame); each call counted
    once in its own counter and once in the column carry's."""
    import torch
    from tpudsp_torch.chains import channelizer as tch
    from tpudsp_torch.cuda import first_order as fo
    from tpudsp_torch.design import iirdes
    from tpudsp_torch.kernels import iir as kiir
    b0, a = iirdes.deemphasis_coeffs(tch.ChannelizerConfig().chan_rate)
    kd = tch.ChannelizedBankConfig().kd
    rng = np.random.default_rng(62)
    n, C = 16385, 1024
    f = rng.uniform(-0.4, 0.4, C)
    Y = (rng.uniform(0.1, 3.0, C) * np.exp(2j * np.pi * f * np.arange(n)[:, None])
         + 0.3 * (rng.standard_normal((n, C)) + 1j * rng.standard_normal((n, C))))
    Y = torch.from_numpy(Y.astype(np.complex64)).to(DEV)
    fd0 = rng.standard_normal(C) + 1j * rng.standard_normal(C)
    fd0 = torch.from_numpy(fd0.astype(np.complex64)).to(DEV)
    y0 = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).to(DEV)

    def check(name, Ye, fd, y):
        own, shared = fo.fm_deemph_cols.launches, fo.first_order_apply_blocked_mc.launches
        k = fo.fm_deemph_cols(b0, a, kd, fd, y, Ye)
        if (fo.fm_deemph_cols.launches - own, fo.first_order_apply_blocked_mc.launches
                - shared) != (1, 1):
            raise AssertionError(f"fm_deemph_cols {name}: not one launch in each counter")
        ref, plain_ms = timed(lambda: kiir.fm_deemph_cols(b0, a, kd, fd, y, Ye))
        err = _compare_exact(f"fm_deemph_cols {name}", k, ref)
        _compare_exact(f"fm_deemph_cols {name}: the last frame is Y's", k[:1], (Ye[-1],))
        return k, err, plain_ms

    main = Y[:16384].contiguous()
    _, err, plain_ms = check("(16384, 1024)", main, fd0, y0)
    _record("fm_deemph_cols", err, plain_ms)
    tile = kiir.COLS_TILE_BLOCKS * kiir.L_BLOCK
    for m in (1, 31, 33, tile - 1, tile, tile + 1, 2 * tile + 1, 16385):
        check(f"({m}, 1024)", Y[:m].contiguous(), fd0, y0)
    for m, c in ((16384, 1022), (3 * tile + 77, 1021), (33, 1021)):
        check(f"({m}, {c})", Y[:m, :c].contiguous(), fd0[:c].contiguous(), y0[:c].contiguous())
    # zero frames and a zero carried frame (patan2 gives 0 at (0, 0));
    # infinite and NaN frames: NaN from them on in their channels
    Yn, fdn = Y[:2 * tile + 3].clone(), fd0.clone()
    Yn[0, 2] = Yn[31, 3] = Yn[32, 3] = Yn[tile - 1, 4] = Yn[tile, 5] = 0.0
    Yn[100:140, 6] = 0.0
    fdn[1] = 0.0
    Yn[40, 1], Yn[37, 2] = complex(float("inf"), 0.0), complex(float("-inf"), 1.0)
    Yn[tile + 70, 0], Yn[tile - 1, 3] = complex(float("nan"), 0.5), complex(0.25, float("inf"))
    Yn[2 * tile, C - 1] = complex(float("nan"), float("nan"))
    k, _, _ = check(f"({2 * tile + 3}, 1024) with zero, infinite and NaN frames", Yn, fdn, y0)
    if not (bool(torch.isnan(k[2]).any()) and bool(torch.isfinite(k[2][6]).all())):
        raise AssertionError("fm_deemph_cols: the non-finite frames did not show as planned")
    fd, y, rfd, ry = fd0, y0, fd0, y0
    for lo, hi in ((0, 5000), (5000, 5001), (5001, 16385)):
        k = fo.fm_deemph_cols(b0, a, kd, fd, y, Y[lo:hi].contiguous())
        r = kiir.fm_deemph_cols(b0, a, kd, rfd, ry, Y[lo:hi])
        _compare_exact(f"fm_deemph_cols chained call {lo}:{hi} of (16385, 1024)", k, r)
        (fd, y, _), (rfd, ry, _) = k, r


def _rows(outs, rows):
    """The given rows of a path's blocks of audio, on the host."""
    import torch
    idx = torch.tensor(rows, device=outs[0].device)
    return torch.cat([o.index_select(0, idx) for o in outs], 1).cpu().numpy()


def channelizer_fm(timings):
    """The FM bank (ChannelizedBankConfig(): the row-major FM fast path) on
    three blocks in c64, i16 and u8 (and the c64 of the i16 / u8 values),
    os = 2 and the 'conv' engine; Y and the FM audio against the float64
    oracle. Returns the c64 bank's audio rows of PFB_FM and the c64
    blocks."""
    from tpudsp_torch.chains import ChannelizedBank, ChannelizedBankConfig, Channelizer
    from tpudsp_torch.chains import ChannelizerConfig
    from tpudsp_torch.design import iirdes
    cfg = ChannelizedBankConfig()
    C = cfg.channelizer.nchan
    wire = {k: _split(v, N_PFB) for k, v in wire_of(pfb_signal(3, seed=31)).items()}
    per_block = {"pfb_branch": 1, "fm_deemph_cols": 1}
    y, rxs = {}, {}
    for fmt in ("c64", "i16", "u8", "c64_i16", "c64_u8"):
        rx = rxs[fmt] = ChannelizedBank(cfg, N_PFB, input_format=fmt[:3], device=DEV)
        outs, _ = _run_chain(f"fm {fmt}", rx, wire[fmt], per_block, phase="channelizer")
        y[fmt] = _rows(outs, PFB_FM)
        if fmt in ("c64", "i16", "u8"):
            timings[f"channelized fm {fmt}"] = (rx, wire[fmt], N_PFB)
    # Y on 16 channels and the FM audio against the float64 oracle, over
    # the block's first N_PFB_ORACLE samples
    h = rxs["c64"].params[0].double().reshape(-1).cpu().numpy()
    ch16 = sorted(PFB_FM + PFB_AM)
    bo = oracle_module("bank_oracle")
    xo = wire["c64"][0][:N_PFB_ORACLE]
    for os_ in (1, 2):
        cc = ChannelizerConfig(oversample=os_)
        Y = Channelizer(cc, N_PFB, device=DEV)(wire["c64"][0])
        M = N_PFB_ORACLE * os_ // C
        Yk = Y[:M, list(ch16)].cpu().numpy()
        ref = bo.channelizer_f64(xo.cpu().numpy(), h, C, os_, ch16)
        worst = min(snr_db(ref[:, i], Yk[:, i]) for i in range(len(ch16)))
        _check(f"Y os={os_}, the 16 carriers' channels ({len(PFB_FM)} FM, {len(PFB_AM)} AM), "
               f"{M} frames vs float64 oracle, worst channel, dB", worst, 120.0, "channelizer")
        if os_ == 1:
            fm_i = [ch16.index(c) for c in PFB_FM]
            b0, a = iirdes.deemphasis_coeffs(cc.chan_rate)
            ref_a = bo.fm_demod_f64(ref[:, fm_i].T, cfg.kd, b0, a)
            worst = min(snr_db(ref_a[i], y["c64"][i, :M]) for i in range(len(PFB_FM)))
            _check(f"FM audio, {len(PFB_FM)} FM channels, {M} frames vs float64 oracle, "
                   "worst channel, dB", worst, 100.0, "channelizer")
    m = N_PFB // C
    for fmt in ("i16", "u8"):
        worst = min(snr_db(y[f"c64_{fmt}"][i, PFB_SETTLE:], y[fmt][i, PFB_SETTLE:])
                    for i in range(len(PFB_FM)))
        _check(f"FM {fmt} vs c64 of the {fmt} values, 3 blocks past frame {PFB_SETTLE}, "
               "worst FM channel, dB", worst, 90.0, "channelizer")
    # oversampled, and the 'conv' engine
    rx2 = ChannelizedBank(ChannelizedBankConfig(channelizer=ChannelizerConfig(oversample=2)),
                          N_PFB, device=DEV)
    outs, _ = _run_chain("fm os=2", rx2, wire["c64"][:2], per_block, phase="channelizer")
    if outs[0].shape != (C, 2 * m):
        raise AssertionError(f"channelizer fm os=2: audio {tuple(outs[0].shape)}")
    rxc = ChannelizedBank(ChannelizedBankConfig(channelizer=ChannelizerConfig(engine="conv")),
                          N_PFB, device=DEV)
    outs, _ = _run_chain("fm conv engine", rxc, wire["c64"][:1], {"fm_deemph_cols": 1},
                         phase="channelizer")
    yc = _rows(outs, PFB_FM)
    worst = min(snr_db(y["c64"][i, :m], yc[i]) for i in range(len(PFB_FM)))
    _check("FM conv engine vs shift, block 0, worst FM channel, dB", worst, 110.0, "channelizer")
    return y["c64"], wire["c64"]


def _am_tones(path: str, audio, chan_rate: float):
    """Each AM carrier's row of the last block's last quarter: DC-free
    (|mean| < 5% of the peak) and on its tone (within 2% of the channel
    rate), tests/test_channelizer.py's pin."""
    q = audio[:, 3 * audio.shape[1] // 4:]
    for k, c in enumerate(PFB_AM):
        a, tone = q[k], PFB_AM_TONES[k % 2]
        peak = _pure_tone_hz(a - a.mean(), chan_rate)
        log(f"channelizer: {path} AM channel {c}: tone {peak:.1f} Hz (want {tone}), mean "
            f"{a.mean():.2e}, peak {np.abs(a).max():.3f}")
        if not (abs(a.mean()) < 0.05 * np.abs(a).max() and abs(peak - tone) < 0.02 * chan_rate):
            raise AssertionError(f"channelizer {path}: AM channel {c} off its tone or not DC-free")


def channelizer_am(timings, y_fm, blocks):
    """Envelope AM, coherent AM on all 1024 channels and a mixed fm /
    coherent am bank (backend 'kernel'), two c64 blocks each: the launches
    a block, the coherent launch bit for bit against its plain version, the
    AM carriers on their tones, the mixed bank's FM rows against the FM
    bank's."""
    from tpudsp_torch.chains import ChannelizedBank, ChannelizedBankConfig
    from tpudsp_torch.chains import channelizer as tch
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.kernels import warmup as kwarm
    blocks = blocks[:2]
    chan_rate = tch.ChannelizerConfig().chan_rate
    rx = ChannelizedBank(ChannelizedBankConfig(demod="am"), N_PFB, device=DEV)
    outs, _ = _run_chain("envelope am", rx, blocks, {"pfb_branch": 1, "first_order_scan": 1},
                         phase="channelizer")
    timings["channelized envelope am c64"] = (rx, blocks, N_PFB)
    w = kwarm.warmup_for(agc_alpha=0.01, pll_bw=0.001)
    # the coherent bank: the matrix instance on Y and one rows tail; the
    # mixed bank: the planes launch on its AM rows, the DC tracker's rows
    # and the de-emphasis
    for name, demod, front, coh in (
            ("coherent am", "am", "front_chunked_mc",
             {"pfb_branch": 1, "am_front_scan": 1, "first_order_scan": 1}),
            ("mixed", ("fm", "am") * 512, "front_chunked",
             {"pfb_branch": 1, "am_front_scan": 1, "first_order_scan": 2})):
        rx = ChannelizedBank(ChannelizedBankConfig(demod=demod, am_coherent=True), N_PFB,
                             backend="kernel", device=DEV)
        outs, (am,) = _run_chain(name, rx, blocks, coh, [(tch, front, 1)],
                                 phase="channelizer")
        p, st, xa, chunk, warmup = am[0][0]
        if (chunk, warmup) != (1024, w):
            raise AssertionError(f"channelizer {name}: chunk {chunk} warmup {warmup}")
        ref = getattr(scan, front + "_ref")
        _compare(f"channelizer {name} am_front_scan {front} {tuple(xa.shape)} chunk "
                 f"{chunk} warmup {warmup}", am[0][1], ref(p, st, xa, chunk, warmup))
        _am_tones(name, _rows(outs, PFB_AM), chan_rate)
        timings[f"channelized {name} c64"] = (rx, blocks, N_PFB)
        if name == "mixed":
            worst = min(snr_db(y_fm[i, :2 * N_PFB // 1024], a)
                        for i, a in enumerate(_rows(outs, PFB_FM)))
            _check("mixed FM rows vs the FM bank's rows, 2 blocks, worst, dB", worst, 100.0,
                   "channelizer")


def _pfb_times(call, alone) -> dict:
    """pfb_branch's call, its launch alone and its kernel's device time (ms)."""
    return {"call_ms": _cuda_ms(call, 10), "alone_ms": _cuda_ms(alone, 10),
            "device_ms": _device_ms(call, "pfb_branch_kernel", 10)}


def _in_turns(mine, parent_lib, name: str) -> dict:
    """mine() with this tree's kernel and, with --parent, with the parent's
    csrc/<name>.cu swapped in, in turns (parent, this, this, parent): each
    key of mine()'s dict as this tree's value (the first of the two) and
    'parent_' + key (the first parent's), the second runs under '2'."""
    if parent_lib is None:
        return mine()
    with library_swapped(name, parent_lib):
        p1 = mine()
    m1, m2 = mine(), mine()
    with library_swapped(name, parent_lib):
        p2 = mine()
    out = {**m1, **{f"{k} 2": v for k, v in m2.items()}}
    out.update({f"parent_{k}": v for k, v in p1.items()})
    out.update({f"parent_{k} 2": v for k, v in p2.items()})
    return out


def time_pfb_and_columns():
    """pfb_branch at config 4's block in c64 / i16 / u8, os 1 and 2, by the
    wrapper's call, its launch alone (output allocated beforehand) and its
    kernel's device time, against its bound; the c64 calls against one
    torch.nn.functional.conv1d (groups C, dilation os; the re and im planes
    as a batch of two, TF32 off). The column carry at (16384, 1024) by the
    call and by its kernel's device time, against its bound and against the
    parent's form (the transpose and a first_order_scan launch of rows).
    The FM bank's fused launch (fm_deemph_cols) at (16384, 1024) by the
    call and by its kernel's device time, against its bound and against
    the eager discriminator passes and the f32 column launch it replaced.
    With --parent, the parent's pfb_branch and its transpose-and-rows form,
    their sources built and swapped in, in turns with this tree's."""
    import torch
    from tpudsp_torch.chains import channelizer as tch
    from tpudsp_torch.cuda import first_order as fo
    from tpudsp_torch.cuda import launch, pfb
    from tpudsp_torch.design import iirdes
    from tpudsp_torch.kernels import iir as kiir
    from tpudsp_torch.kernels.fastmath import patan2
    from tpudsp_torch.kernels import pfb as kpfb
    cfg = tch.ChannelizerConfig()
    C, T = cfg.nchan, cfg.taps_per_branch
    wire = wire_of(pfb_signal(1, seed=32))
    parent_pfb = parent_library("pfb_branch") if PARENT else None
    out = {}
    for kind, fmt in enumerate(("c64", "i16", "u8")):
        Ht, st = tch.build(cfg, fmt, device=DEV)
        x, tail = wire[fmt], st.tail
        for os_ in (1, 2):
            M = N_PFB * os_ // C
            nbytes = x.numel() * x.element_size() + M * C * 8
            b = max(nbytes / HBM_BPS, 4.0 * T * M * C / F32_FLOPS) * 1e3
            u = torch.empty((M, C), dtype=torch.complex64, device=DEV)
            call = lambda: pfb.branch_accumulate(Ht, tail, x, os_)
            alone = lambda: launch.launch("pfb_branch", x.device, Ht, tail, x, u, kind, T, C,
                                          os_, M)
            key = f"{fmt} os={os_}"
            out[key] = {"bound_ms": b, **_in_turns(lambda: _pfb_times(call, alone), parent_pfb,
                                                   "pfb_branch")}
            if fmt == "c64":
                V = torch.cat([tail, x])[kpfb.frame_index(M, T, C, os_, x.device)]
                planes = torch.view_as_real(V).permute(2, 1, 0).contiguous()
                del V
                K = Ht.flip(0).T.reshape(C, 1, T).contiguous()
                torch.backends.cudnn.allow_tf32 = False
                conv = lambda: torch.nn.functional.conv1d(planes, K, dilation=os_, groups=C)
                yc = conv()
                s = snr_db(call().cpu().numpy(),
                           torch.complex(yc[0], yc[1]).T.contiguous().cpu().numpy())
                out[key]["conv1d_ms"] = _cuda_ms(conv, 10)
                out[key]["conv1d_vs_kernel_db"] = s
                del planes, yc
            v = out[key]
            log(f"timing: pfb_branch {key} N={N_PFB}: call {v['call_ms']:.4f} ms, launch alone "
                f"{v['alone_ms']:.4f}, device {v['device_ms']:.4f}, bound {b:.4f} "
                f"({v['device_ms'] / b:.2f}x by the device); {json.dumps(v)}")
            if key == "c64 os=1":
                k = results["kernels"]["pfb_branch"]
                k.update(ms=v["call_ms"], library_ms=v["conv1d_ms"])
                bound("pfb_branch", nbytes, 4.0 * T * M * C)
            del u
    b0, a = iirdes.deemphasis_coeffs(cfg.chan_rate)
    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.standard_normal((16384, C)).astype(np.float32)).to(DEV)
    y0 = torch.zeros(C, device=DEV)
    tab = kiir.device_table(float(b0), float(a), x.device)
    # the parent's form: the f32 transpose and one launch of C rows
    rows = lambda: fo._launch("first_order_scan", (tab,), None, x.T.contiguous(), (y0,))
    cols_call = lambda: fo.first_order_apply_blocked_mc(b0, a, y0, x)
    cols = {"call_ms": _cuda_ms(cols_call, 10),
            "device_ms": _device_ms(cols_call, "first_order_cols_kernel", 10)}
    parent_fo = parent_library("first_order_scan") if PARENT else None
    cols.update({f"transpose + rows {k}": v for k, v in _in_turns(
        lambda: {"call_ms": _cuda_ms(rows, 10),
                 "rows_device_ms": _device_ms(rows, "first_order_scan_kernel", 10)},
        parent_fo, "first_order_scan").items()})
    cols["bound_ms"] = max(x.numel() * 8 / HBM_BPS, x.numel() * OPS_FIRST_ORDER / F32_FLOPS) * 1e3
    out["column carry (16384, 1024)"] = cols
    log(f"timing: first_order_scan column carry (16384, 1024): call {cols['call_ms']:.4f} ms, "
        f"device {cols['device_ms']:.4f}, bound {cols['bound_ms']:.4f} "
        f"({cols['call_ms'] / cols['bound_ms']:.2f}x by the call); {json.dumps(cols)}")
    results["kernels"]["first_order_scan_mc"]["ms"] = cols["call_ms"]
    bound("first_order_scan_mc", x.numel() * 8, x.numel() * OPS_FIRST_ORDER)
    # the FM bank's fused launch at (16384, 1024) from a channel matrix of
    # tones, against the parent's form of the same step: the eager
    # discriminator passes, the f32 column launch and the last frame's clone
    del x
    kd = tch.ChannelizedBankConfig().kd
    f = rng.uniform(-0.4, 0.4, C)
    Y = torch.from_numpy((rng.uniform(0.1, 3.0, C) * np.exp(
        2j * np.pi * f * np.arange(16384)[:, None])).astype(np.complex64)).to(DEV)
    fd0 = Y[-1].clone()
    fm_call = lambda: fo.fm_deemph_cols(b0, a, kd, fd0, y0, Y)
    div = float(np.float32(2.0 * np.pi * kd))

    def eager():
        d = Y * torch.conj(torch.cat([fd0[None, :], Y[:-1]], 0))
        last, audio = fo.first_order_apply_blocked_mc(b0, a, y0, patan2(d.imag, d.real) / div)
        return Y[-1].clone(), last, audio.T.contiguous()

    fm = {"call_ms": _cuda_ms(fm_call, 10),
          "device_ms": _device_ms(fm_call, "first_order_cols_kernel", 10),
          "eager_form_call_ms": _cuda_ms(eager, 10)}
    nbytes = Y.numel() * (8 + 4)
    fm["bound_ms"] = max(nbytes / HBM_BPS, Y.numel() * (OPS_FIRST_ORDER + OPS_FM_DISCRIMINATOR)
                         / F32_FLOPS) * 1e3
    out["fm_deemph_cols (16384, 1024)"] = fm
    log(f"timing: fm_deemph_cols (16384, 1024): call {fm['call_ms']:.4f} ms, device "
        f"{fm['device_ms']:.4f}, bound {fm['bound_ms']:.4f} ({fm['device_ms'] / fm['bound_ms']:.2f}x "
        f"by the device); the eager passes and the f32 column launch: call "
        f"{fm['eager_form_call_ms']:.4f} ms; {json.dumps(fm)}")
    results["kernels"]["fm_deemph_cols"]["ms"] = fm["call_ms"]
    bound("fm_deemph_cols", nbytes, Y.numel() * (OPS_FIRST_ORDER + OPS_FM_DISCRIMINATOR))
    return out


def channelizer_block_times() -> dict:
    """Each config 4 path's block time with whatever tpudsp_torch is
    imported (this tree's, or --channelizer-root's): the FM bank in c64 /
    i16 / u8, envelope AM, coherent AM and the mixed bank (backend
    'kernel'), each the median of 5 blocks after a warm-up block, by the
    host clock with a synchronise and by CUDA events. Uses only entry
    points the package has had since the channelizer's port."""
    from tpudsp_torch.chains import ChannelizedBank, ChannelizedBankConfig
    wire = {k: _split(v, N_PFB) for k, v in wire_of(pfb_signal(2, seed=34)).items()}
    paths = {f"fm {f}": (ChannelizedBankConfig(), f, {}) for f in ("c64", "i16", "u8")}
    paths["envelope am c64"] = (ChannelizedBankConfig(demod="am"), "c64", {})
    paths["coherent am c64"] = (ChannelizedBankConfig(demod="am", am_coherent=True), "c64",
                                {"backend": "kernel"})
    paths["mixed c64"] = (ChannelizedBankConfig(demod=("fm", "am") * 512, am_coherent=True),
                          "c64", {"backend": "kernel"})
    out = {}
    for path, (cfg, fmt, kw) in paths.items():
        rx = ChannelizedBank(cfg, N_PFB, input_format=fmt, device=DEV, **kw)
        blocks = (wire[fmt] * 3)[:6]
        med, spread = _block_times(rx, blocks)
        out[path] = {"host_ms": med * 1e3, "host_spread": spread,
                     "cuda_event_ms": _block_device_ms(rx, blocks)}
    return out


def parent_report(flag: str) -> dict:
    """This file run with ``flag`` and --parent's checkout, in a process of
    its own: the JSON object it prints last."""
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag, str(PARENT)],
                         capture_output=True, text=True, timeout=600)
    line = res.stdout.strip().splitlines()[-1:] if res.returncode == 0 else []
    if not line:
        raise AssertionError(f"the parent's {flag} process failed: {res.stderr[-2000:]}")
    return json.loads(line[0])


def phase_channelizer():
    """BASELINE config 4 on the card at full width: each kernel of its path
    held against its plain version, every path's launches a block, Y and
    the FM audio against the float64 oracle, the wire formats, the 'conv'
    engine, the coherent AM channels; each path's block time, pfb_branch's
    and the column carry's times, am_front_scan's matrix instance's and
    the rows tail's."""
    kernel_pfb()
    kernel_first_order_mc()
    kernel_fm_deemph_cols()
    timings: dict = {}
    y_fm, blocks = channelizer_fm(timings)
    channelizer_am(timings, y_fm, blocks)
    time_front_mc()
    res = time_receivers(timings)
    for path, v in res.items():
        log(f"timing: {path}: {N_PFB / v['host_ms'] / 1e3:.1f} Msamp/s by the host clock, "
            f"{N_PFB / v['cuda_event_ms'] / 1e3:.1f} by CUDA events, against the 100 Msps "
            f"of radio a block carries ({N_PFB / PFB_FS * 1e3:.1f} ms of it)")
    res["kernels"] = time_pfb_and_columns()
    if PARENT:
        # each path's block time beside the parent's: this tree, the
        # parent's package in a process of its own, this tree again
        mine = channelizer_block_times()
        parent = parent_report("--channelizer-root")
        again = channelizer_block_times()
        for path, v in mine.items():
            p = parent[path]
            log(f"timing: channelizer {path} block: this tree {v['host_ms']:.3f} / "
                f"{again[path]['host_ms']:.3f} ms by the host clock, {v['cuda_event_ms']:.3f} / "
                f"{again[path]['cuda_event_ms']:.3f} by CUDA events; the parent's "
                f"{p['host_ms']:.3f} / {p['cuda_event_ms']:.3f}")
        res["beside the parent"] = {"this tree": mine, "parent": parent, "this tree again": again}
    log(f"timing: channelizer: {json.dumps(res)}")


# --------------------------------------------------------------------------
# parallel: the rest of the sharded runtime on one card (one-rank meshes;
# NCCL refuses two ranks on one card: chip_sharded.py runs the rings)
N_PIPE = 4                  # the pipeline's and the elastic runner's 4M-sample blocks


def _snr_dev(ref, y) -> float:
    """SNR (dB) of y against ref, reduced on the card in float64."""
    import torch
    ref, y = ref.to(torch.complex128 if ref.is_complex() else torch.float64), y.to(ref.dtype)
    err = float((ref - y).abs().square().sum())
    sig = float(ref.abs().square().sum())
    return float("inf") if err == 0 else 10.0 * np.log10(sig / err)


def _against(what: str, ref, y, bar: float):
    """y against ref on the card: bit for bit, or the SNR and max-abs
    difference printed and held to ``bar`` dB."""
    import torch
    if ref.shape != y.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"parallel: {what}: shape {tuple(y.shape)} vs {tuple(ref.shape)} "
                             "or not finite")
    if torch.equal(ref, y):
        log(f"parallel: {what}: bit for bit")
        return
    s = _snr_dev(ref, y)
    log(f"parallel: {what}: {s:.2f} dB, max abs difference "
        f"{float((ref - y).abs().max()):.3e} (bar {bar:g})")
    if not s >= bar:
        raise AssertionError(f"parallel: {what} {s:.2f} dB, bar {bar:g}")


def _parallel_times(name: str, rx, blocks, beside: dict):
    """rx's block time (host clock median of 5 with spread, CUDA events)
    beside the chains in ``beside``, each on the same blocks in turn."""
    out = {}
    for label, r in {name: rx, **beside}.items():
        med, spread = _block_times(r, blocks)
        out[label] = {"host_ms": med * 1e3, "host_spread": spread,
                      "cuda_event_ms": _block_device_ms(r, blocks)}
        log(f"timing: parallel {label}: median {med * 1e3:.3f} ms of 5 (spread "
            f"{spread * 100:.1f}%), CUDA events {out[label]['cuda_event_ms']:.3f} ms")
    results.setdefault("parallel", {})[name] = out


def parallel_bank():
    """ShardedBank on a (1, 1) mesh: bank16 on three 8M-sample blocks in
    c64 / i16 / u8 with halo='ppermute', c64 with halo='async', and the
    mixed fm / coherent am / usb / lsb bank, each against the single-card
    ReceiverBank on the same blocks (the mixed one with backend 'xla', the
    sharded coherent back end's chunk)."""
    import torch
    from tpudsp_torch.chains import BankConfig, ReceiverBank
    from tpudsp_torch.parallel import ShardedBank, make_mesh
    mesh = make_mesh(1, 1, DEV)
    cfg = BankConfig(freqs=BANK_FREQS)
    wire = {k: _split(v, N_BANK) for k, v in wire_of(bank_signal(3 * N_BANK, ("fm",) * 16,
                                                                   seed=40)).items()}
    fm = {"halo_async": 1, "first_order_scan": 1}
    for fmt, halo in (("c64", "ppermute"), ("i16", "ppermute"), ("u8", "ppermute"),
                      ("c64", "async")):
        sb = ShardedBank(cfg, mesh, N_BANK, halo=halo, input_format=fmt, device=DEV)
        # async: the interior and the boundary outputs, two launches a block
        want = dict(fm, halo_async=2) if halo == "async" else fm
        outs, _ = _run_chain(f"ShardedBank 1x1 bank16 {fmt} {halo}", sb, wire[fmt], want,
                             phase="parallel")
        ref = ReceiverBank(cfg, N_BANK, input_format=fmt, device=DEV)
        y_ref = torch.cat([ref(b) for b in wire[fmt]], 1)
        _against(f"ShardedBank bank16 {fmt} {halo} vs ReceiverBank, 3 blocks", y_ref,
                 torch.cat(outs, 1), 120.0)
        if fmt == "c64" and halo == "async":
            _parallel_times("ShardedBank bank16 c64 async", sb, wire[fmt] * 2, {
                "ShardedBank bank16 c64 ppermute": ShardedBank(cfg, mesh, N_BANK, device=DEV),
                "ReceiverBank bank16 c64": ref})
    cfg = BankConfig(freqs=BANK_FREQS, demod=MIXED, am_coherent=True)
    blocks = _split(bank_signal(3 * N_BANK, MIXED, seed=41).to(torch.complex64), N_BANK)
    sb = ShardedBank(cfg, mesh, N_BANK, device=DEV)
    # am_front_scan: the chunked launch and the exact re-run of the padded
    # last chunk (800,000 channel samples, chunk 3840)
    outs, _ = _run_chain("ShardedBank 1x1 mixed", sb, blocks,
                         {"halo_async": 1, "am_front_scan": 2, "first_order_scan": 2},
                         phase="parallel")
    ref = ReceiverBank(cfg, N_BANK, backend="xla", device=DEV)
    _against("ShardedBank mixed fm / coherent am / usb / lsb vs ReceiverBank(backend='xla'), "
             "3 blocks", torch.cat([ref(b) for b in blocks], 1), torch.cat(outs, 1), 120.0)


def parallel_channelizer():
    """ShardedChannelizer and ShardedChannelizedBank on a one-rank mesh at
    config 4's width (ChannelizedBankConfig(), blocks of 1024 x 16384),
    with c1 = 32 (the twiddle and both transform stages run) and c1 =
    None: Y of the carriers' channels against the single-card Channelizer
    (>= 120 dB), the FM bank in c64 / i16 / u8 and the coherent AM bank
    against the single-card ChannelizedBank (>= 100 dB)."""
    import torch
    from tpudsp_torch.chains import ChannelizedBank, ChannelizedBankConfig, Channelizer
    from tpudsp_torch.parallel import (ShardedChannelizedBank, ShardedChannelizer,
                                       make_mesh)
    mesh = make_mesh(1, 1, DEV)
    cfg = ChannelizedBankConfig()
    carriers = torch.tensor(PFB_FM + PFB_AM, device=DEV)
    wire = {k: _split(v, N_PFB) for k, v in wire_of(pfb_signal(3, seed=42)).items()}
    ref = Channelizer(cfg.channelizer, N_PFB, device=DEV)
    Y_ref = torch.cat([ref(b) for b in wire["c64"]], 0).index_select(1, carriers)
    for c1 in (32, None):
        sc = ShardedChannelizer(cfg.channelizer, mesh, N_PFB, c1=c1, device=DEV)
        outs, _ = _run_chain(f"ShardedChannelizer c1={c1}", sc, wire["c64"], {"pfb_branch": 1},
                             phase="parallel")
        _against(f"ShardedChannelizer c1={c1} Y of the 16 carriers' channels vs Channelizer, "
                 "3 blocks", Y_ref, torch.cat(outs, 0).index_select(1, carriers), 120.0)
    fm = torch.tensor(PFB_FM, device=DEV)
    for fmt, c1 in (("c64", 32), ("i16", 32), ("u8", 32), ("c64", None)):
        sb = ShardedChannelizedBank(cfg, mesh, N_PFB, c1=c1, input_format=fmt, device=DEV)
        outs, _ = _run_chain(f"ShardedChannelizedBank FM {fmt} c1={c1}", sb, wire[fmt],
                             {"pfb_branch": 1, "fm_deemph_cols": 1}, phase="parallel")
        rb = ChannelizedBank(cfg, N_PFB, input_format=fmt, device=DEV)
        _against(f"ShardedChannelizedBank FM {fmt} c1={c1} audio of the FM carriers vs "
                 "ChannelizedBank, 3 blocks", torch.cat([rb(b) for b in wire[fmt]], 1)
                 .index_select(0, fm), torch.cat(outs, 1).index_select(0, fm), 100.0)
        if fmt == "c64" and c1 == 32:
            _parallel_times("ShardedChannelizedBank config 4 FM c64 c1=32", sb,
                            wire[fmt] * 2, {"ChannelizedBank config 4 FM c64": rb})
    acfg = ChannelizedBankConfig(demod="am", am_coherent=True)
    am = torch.tensor(PFB_AM, device=DEV)
    sb = ShardedChannelizedBank(acfg, mesh, N_PFB, c1=32, device=DEV)
    # am_front_scan: the chunked launch and the exact re-run of the padded
    # last chunk (16,384 frames, the 'xla' chunk 3840)
    outs, _ = _run_chain("ShardedChannelizedBank coherent AM c1=32", sb, wire["c64"],
                         {"pfb_branch": 1, "am_front_scan": 2, "first_order_scan": 2},
                         phase="parallel")
    rb = ChannelizedBank(acfg, N_PFB, device=DEV)
    _against("ShardedChannelizedBank coherent AM c1=32 audio of the AM carriers vs "
             "ChannelizedBank, 3 blocks", torch.cat([rb(b) for b in wire["c64"]], 1)
             .index_select(0, am), torch.cat(outs, 1).index_select(0, am), 100.0)


def parallel_scanner():
    """ShardedScanner on a (1, 1) mesh, config 5's one-chip core as
    bench.py:541-547 runs it (ChannelizedBankConfig(), blocks of 1024 x
    16384): FM in c64 and u8 and coherent AM, the carriers' audio against
    the single-card ChannelizedBank (>= 100 dB)."""
    import torch
    from tpudsp_torch.chains import ChannelizedBank, ChannelizedBankConfig
    from tpudsp_torch.parallel import ShardedScanner, make_mesh
    mesh = make_mesh(1, 1, DEV)
    wire = {k: _split(v, N_PFB) for k, v in wire_of(pfb_signal(3, seed=43)).items()}
    cases = (("FM c64", ChannelizedBankConfig(), "c64", PFB_FM,
              {"pfb_branch": 1, "first_order_scan": 1}),
             ("FM u8", ChannelizedBankConfig(), "u8", PFB_FM,
              {"pfb_branch": 1, "first_order_scan": 1}),
             ("coherent AM c64", ChannelizedBankConfig(demod="am", am_coherent=True), "c64",
              PFB_AM, {"pfb_branch": 1, "am_front_scan": 2, "first_order_scan": 2}))
    for label, cfg, fmt, chans, per_block in cases:
        sc = ShardedScanner(cfg, mesh, N_PFB, input_format=fmt, device=DEV)
        outs, _ = _run_chain(f"ShardedScanner 1x1 {label}", sc, wire[fmt], per_block,
                             phase="parallel")
        rb = ChannelizedBank(cfg, N_PFB, input_format=fmt, device=DEV)
        idx = torch.tensor(chans, device=DEV)
        _against(f"ShardedScanner {label} audio of its carriers vs ChannelizedBank, 3 blocks",
                 torch.cat([rb(b) for b in wire[fmt]], 1).index_select(0, idx),
                 torch.cat(outs, 1).index_select(0, idx), 100.0)
        if label == "FM c64":
            _parallel_times("ShardedScanner config 5 core FM c64", sc, wire[fmt] * 2,
                            {"ChannelizedBank config 4 FM c64": rb})


def parallel_pipeline():
    """PipelinedAMReceiver with both stages on the one card, each on its own
    stream: AMConfig() on four 4M-sample blocks and the flush in c64 / i16
    / u8, bit for bit against AMReceiver(backend='xla') on the same blocks;
    its launches: the back end's on every call but the fill call."""
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.parallel import PipelinedAMReceiver
    cfg = AMConfig()
    data = wire_blocks(N_PIPE, BLOCK_4M, seed=44)
    stages = (DEV + ":0", DEV + ":0")
    per_block = AM_OPTIONS["xla"][1]
    for fmt in ("c64", "i16", "u8"):
        blocks = [torch.from_numpy(b).to(DEV) for b in data[fmt]]
        pp = PipelinedAMReceiver(cfg, BLOCK_4M, mesh=stages, input_format=fmt)
        torch.cuda.synchronize()
        zero_counts()                                  # the path starts
        outs = [pp(b) for b in blocks]
        outs.append(pp.flush())
        torch.cuda.synchronize()
        expect_counts(f"parallel PipelinedAMReceiver {fmt}", read_counts(),   # ... and ends
                      {k: N_PIPE * v for k, v in per_block.items()})
        if outs[0] is not None:
            raise AssertionError("parallel: the pipeline's fill call returned pcm")
        rx = AMReceiver(cfg, BLOCK_4M, fmt, backend="xla", device=DEV)
        _against(f"PipelinedAMReceiver {fmt} ({N_PIPE} blocks and the flush) vs "
                 "AMReceiver(backend='xla')", torch.cat([rx(b) for b in blocks]),
                 torch.cat(outs[1:]), float("inf"))
        if fmt == "c64":
            pp(blocks[0])     # the fill call: every timed call is a whole stage pair
            _parallel_times("PipelinedAMReceiver c64 (two streams on one card)", pp,
                            blocks + blocks[:2], {"AMReceiver(backend='xla') c64": rx})


class _FailsOnce:
    """AMReceiver whose call on block ``fail_at`` raises, once: a lost card
    or transport in the elastic runner's path."""
    calls = 0

    def __init__(self, fail_at: int):
        from tpudsp_torch.chains.am import AMConfig, AMReceiver
        self.rx = AMReceiver(AMConfig(), BLOCK_4M, device=DEV)
        self.fail_at = fail_at

    @property
    def state(self):
        return self.rx.state

    @state.setter
    def state(self, s):
        self.rx.state = s

    def __call__(self, block):
        _FailsOnce.calls += 1
        if _FailsOnce.calls == self.fail_at + 1:
            raise RuntimeError("the card went away")
        return self.rx(block)


def parallel_elastic(scratch: Path):
    """ElasticRunner over AMReceiver on 4M-sample blocks, snapshot_every=2,
    the chain raising once at block 3: after the restore and the replay
    from the snapshot of block 2 the pcm equals an uninterrupted run bit
    for bit."""
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.parallel import ElasticRunner
    blocks = [torch.from_numpy(b).to(DEV) for b in wire_blocks(5, BLOCK_4M, seed=45)["c64"]]
    rx = AMReceiver(AMConfig(), BLOCK_4M, device=DEV)
    truth = torch.cat([rx(b) for b in blocks])
    _FailsOnce.calls = 0
    runner = ElasticRunner(lambda: _FailsOnce(fail_at=3), str(scratch / "am"), snapshot_every=2)
    out, i, resumed = [], 0, []
    while i < len(blocks):
        try:
            out.append(runner(blocks[i]))
            i += 1
        except RuntimeError:
            resumed.append((i, runner.block_index))
            i = runner.block_index
            out = out[:i]
    log(f"parallel: ElasticRunner: failed at and resumed from blocks {resumed}, replayed to "
        f"block {len(blocks)}")
    if resumed != [(3, 2)]:
        raise AssertionError(f"parallel: ElasticRunner: failed at and resumed from {resumed}, "
                             "not [(3, 2)]")
    _against("ElasticRunner(AMReceiver) resumed and replayed vs an uninterrupted run",
             truth, torch.cat(out), float("inf"))


def phase_parallel():
    """The rest of the sharded runtime on the card through its entry points
    (one-rank meshes and both pipeline stages on one card): ShardedBank,
    ShardedChannelizer and ShardedChannelizedBank, ShardedScanner,
    PipelinedAMReceiver, ElasticRunner; each against its single-card chain,
    its launches counted, its block time beside the chain's."""
    import tempfile
    parallel_bank()
    parallel_channelizer()
    parallel_scanner()
    parallel_pipeline()
    with tempfile.TemporaryDirectory() as d:
        parallel_elastic(Path(d))
    log(f"timing: parallel: {json.dumps(results.get('parallel', {}))}")


# --------------------------------------------------------------------------
# stream: the io runtime driving the ported chains from raw radio bytes
N_STREAM_AM = 4             # blocks of each AM runtime cell (a fifth: the checkpoint's next)
N_STREAM_BANK = 3
N_STREAM_PFB = 8            # config 4 blocks pushed at the radio's rate ...
PFB_DISTINCT = 3            # ... of this many distinct ones, replayed in turn
STREAM_CHUNK = 1 << 18      # samples a push
PFB_WIRE_BPS = 2 * PFB_FS   # config 4's u8 wire: 200 MB/s
# sample_format and input_format of the AM cells, by the receiver's format
AM_STREAM = {"i16": ("int16_raw", "i16"), "u8": ("uint8_raw", "u8"), "c64": ("int16", "c64")}
PER_BLOCK = {"am": {"am_front_scan": 1, "first_order_scan": 1},
             "bank16": BANK16_PER_BLOCK,
             "config4": {"pfb_branch": 1, "fm_deemph_cols": 1}}


def _same_bits(path: str, got, want):
    """Two lists of float32 audio blocks equal bit for bit."""
    ok = len(got) == len(want) and all(
        a.shape == b.shape and np.array_equal(np.asarray(a).view(np.uint32),
                                              np.asarray(b).view(np.uint32))
        for a, b in zip(got, want))
    log(f"stream: {path}: {len(got)} blocks of audio, bit-equal to serial calls {ok}")
    if not ok:
        raise AssertionError(f"stream {path}: the runtime's audio differs from serial calls")


def _serial(rx, blocks, to_card):
    """A user's serial loop: each host block to the card, the receiver, its
    audio back to the host. Returns (the audio, seconds)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [rx(to_card(b)).cpu().numpy() for b in blocks]
    return out, time.perf_counter() - t0


def _push_all(rt, wire: bytes, chunk: int, bps: float | None = None, marks=None):
    """Push wire in chunks of ``chunk`` bytes, at ``bps`` bytes a second
    (by deadline) or as fast as the ring takes them; ``marks`` (a list)
    gets (bytes pushed, the clock after the push, how late the push began
    against its deadline) for each chunk."""
    t0 = time.perf_counter()
    for i in range(0, len(wire), chunk):
        late = 0.0
        if bps:
            late = time.perf_counter() - (t0 + i / bps)
            if late < 0:
                time.sleep(-late)
        rt.push(wire[i:i + chunk])
        if marks is not None:
            marks.append((min(i + chunk, len(wire)), time.perf_counter(), max(late, 0.0)))


def _pusher(rt, wire: bytes, chunk: int, bps: float | None = None, marks=None):
    """A feed for _drive: a producer thread pushing wire, ended by joining
    it and stopping the runtime."""
    def start():
        th = threading.Thread(target=_push_all, args=(rt, wire, chunk, bps, marks))
        th.start()

        def finish():
            th.join()
            rt.stop(drain=True)
        return finish
    return start


def _drive(rt, start, n_blocks: int, profile: bool = False):
    """Feed rt (``start()`` begins the feed and returns what ends it) and
    pop n_blocks of audio on this thread: (the audio, seconds from the
    feed's start to the last audio, the device's busy share over that
    window by profile_block's method, or None, and the clock at each
    block's audio)."""
    import torch
    from torch.profiler import ProfilerActivity
    ctx = (torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profile else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        finish = start()
        out, popped = [], []
        for _ in range(n_blocks):
            a = rt.pop_audio(timeout=120)
            if a is None:
                raise AssertionError(f"stream: {len(out)} of {n_blocks} blocks of audio came")
            out.append(a)
            popped.append(time.perf_counter())
        wall = time.perf_counter() - t0
        finish()
    return out, wall, device_busy(list(prof.events())) if profile else None, popped


def _cell(path: str, make_rt, start_of, n_blocks: int, n_samples: int, serial, serial_s,
          per_block: dict):
    """One runtime cell: a run with its launches counted (the counts set to
    0 just before, read just after) and its audio bit for bit against the
    serial calls, then a profiled run, also bit-equal; logs the runtime's
    samples/s beside the serial loop's and the busy share, and where the
    feed marks its pushes (``start_of(rt, marks)``) each block's latency
    from the push of its last byte to its audio and how far the producer
    fell behind its schedule."""
    import torch
    torch.cuda.synchronize()
    zero_counts()                                          # the path starts
    rt = make_rt()
    marks: list = []
    out, wall, _, popped = _drive(rt, start_of(rt, marks), n_blocks)
    torch.cuda.synchronize()
    expect_counts(f"stream {path}", read_counts(),         # ... and ends
                  {k: n_blocks * v for k, v in per_block.items()})
    _same_bits(path, out, serial)
    if rt.stats["dropped_bytes"]:
        raise AssertionError(f"stream {path}: {rt.stats}")
    rt = make_rt()
    out, _, busy, _ = _drive(rt, start_of(rt, None), n_blocks, profile=True)
    _same_bits(f"{path} (profiled run)", out, serial)
    res = {"samples_per_s": n_samples / wall, "wall_s": wall,
           "serial_samples_per_s": n_samples / serial_s, "serial_s": serial_s,
           "busy_share": busy["busy_share"], "busy_ms": busy["busy_ms"],
           "window_ms": busy["window_ms"], "device_activities": busy["device_activities"]}
    log(f"timing: stream {path}: runtime {res['samples_per_s'] / 1e6:.1f} Msamp/s "
        f"({n_samples} samples, {wall:.4f} s from the first push to the last audio), serial "
        f"loop {res['serial_samples_per_s'] / 1e6:.1f} Msamp/s ({serial_s:.4f} s); device "
        f"busy {busy['busy_ms']:.3f} of {busy['window_ms']:.3f} ms "
        f"({busy['device_activities']} activities, share {busy['busy_share']})")
    if marks:
        block_bytes = marks[-1][0] // n_blocks
        pushed = [next(t for end, t, _ in marks if end >= (k + 1) * block_bytes)
                  for k in range(n_blocks)]
        res.update(latency_ms=[(a - b) * 1e3 for a, b in zip(popped, pushed)],
                   producer_late_ms=max(late for _, _, late in marks) * 1e3)
        log(f"timing: stream {path}: each block's audio "
            f"{[round(v, 3) for v in res['latency_ms']]} ms after the push of its last "
            f"byte; the producer at most {res['producer_late_ms']:.3f} ms behind its schedule")
    results.setdefault("stream", {})[path] = res
    return rt


def stream_am(serials: dict):
    """Config 1's AMReceiver at 4M-sample blocks through StreamRuntime in
    each wire format, pushed in STREAM_CHUNK-sample chunks; the serial
    loop's audio and block 5 (the checkpoint's) kept in ``serials``."""
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.io import StreamRuntime, bytes_to_iq
    data = wire_blocks(N_STREAM_AM + 1, BLOCK_4M, seed=40)
    for fmt, (sample_format, input_format) in AM_STREAM.items():
        raw = data["u8" if fmt == "u8" else "i16"]
        wire = b"".join(b.tobytes() for b in raw[:N_STREAM_AM])
        to_card = ((lambda b: torch.from_numpy(bytes_to_iq(b.tobytes())).to(DEV))
                   if fmt == "c64" else (lambda b: torch.from_numpy(b).to(DEV)))
        make_rx = lambda: AMReceiver(AMConfig(), BLOCK_4M, input_format, device=DEV)
        serial, _ = _serial(make_rx(), raw[:N_STREAM_AM], to_card)   # also the warm-up
        _, serial_s = _serial(make_rx(), raw[:N_STREAM_AM], to_card)
        chunk = STREAM_CHUNK * (2 if fmt == "u8" else 4)
        _cell(f"am {fmt} ({sample_format})",
              lambda: StreamRuntime(make_rx(), sample_format=sample_format, capacity_blocks=8),
              lambda rt, marks: _pusher(rt, wire, chunk, marks=marks), N_STREAM_AM,
              N_STREAM_AM * BLOCK_4M,
              serial, serial_s, PER_BLOCK["am"])
        serials[f"am {fmt}"] = (raw, wire, serial, to_card)


def bank16_render(n: int):
    """bank16's carriers (bank_signal, made on the card) as complex64 on
    the host, and a render(n0, n) over them for MockRTLSDRDriver."""
    import torch
    x = bank_signal(n, ("fm",) * 16, seed=41).to(torch.complex64).cpu().numpy()
    return lambda n0, m: x[n0:n0 + m]


def stream_bank16(serials: dict):
    """Config 3's bank16 (u8, 8M-sample blocks) fed by RadioSource from a
    MockRTLSDRDriver over its render, 'uint8_raw': bit-equal to serial
    calls on the mock's bytes, each channel on its tone; a burst into a
    one-block ring drops whole chunks, counted alike by the source and the
    ring."""
    import torch
    from tpudsp_torch.chains import BankConfig, ReceiverBank
    from tpudsp_torch.io import MockRTLSDRDriver, RadioSource, StreamRuntime
    cfg = BankConfig(freqs=BANK_FREQS)
    total = N_STREAM_BANK * N_BANK
    render = bank16_render(total)
    chunks = []
    MockRTLSDRDriver(render, total, sample_rate=2.4e6, variable=False).read_bytes_async(
        lambda b, ctx: chunks.append(b), num_bytes=2 * total)
    wire = b"".join(chunks)
    raw = [np.frombuffer(wire, np.uint8)[2 * k * N_BANK:2 * (k + 1) * N_BANK].reshape(-1, 2)
           for k in range(N_STREAM_BANK)]
    to_card = lambda b: torch.from_numpy(b.copy()).to(DEV)
    make_rx = lambda: ReceiverBank(cfg, N_BANK, input_format="u8", device=DEV)
    serial, _ = _serial(make_rx(), raw, to_card)
    _, serial_s = _serial(make_rx(), raw, to_card)

    def start_of(rt, _marks):
        def start():
            src = RadioSource(rt)
            src.run_async(MockRTLSDRDriver(render, total, sample_rate=2.4e6, variable=True,
                                           seed=42), chunk_bytes=262144)

            def finish():
                while src.bytes_delivered < 2 * total:
                    time.sleep(0.01)
                src.stop(drain=True)
                if src.overflow_chunks or src.error is not None:
                    raise AssertionError(f"stream bank16: {src.stats}")
            return finish
        return start
    _cell("bank16 u8 (RadioSource, mock RTL-SDR)",
          lambda: StreamRuntime(make_rx(), sample_format="uint8_raw", capacity_blocks=8),
          start_of, N_STREAM_BANK, total, serial, serial_s, PER_BLOCK["bank16"])
    last = serial[-1]
    tones = [_pure_tone_hz(last[c] - last[c].mean(), cfg.audio_rate) for c in range(16)]
    off = max(abs(f - (400.0 + 150.0 * c)) for c, f in enumerate(tones))
    log(f"stream: bank16 tones {[round(f, 1) for f in tones]} Hz, worst {off:.2f} Hz off")
    if not off < 25.0:
        raise AssertionError("stream bank16: a channel is off its tone")
    # the burst: the pump held until the mock is done, a ring of one block
    bank, held = make_rx(), threading.Event()

    def held_bank(iq):
        held.wait(60)
        return bank(iq)
    rt = StreamRuntime(held_bank, N_BANK, sample_format="uint8_raw", capacity_blocks=1,
                       device=DEV)
    src = RadioSource(rt)
    MockRTLSDRDriver(render, total, sample_rate=2.4e6, variable=True, burst_chunks=10 ** 9,
                     seed=43).read_bytes_async(src, num_bytes=min(262144, N_BANK // 8))
    held.set()
    src.stop(drain=True)
    audio, st = list(rt), src.stats
    log(f"stream: bank16 burst into a one-block ring: {st}")
    if not (st["overflow_chunks"] > 0 and st["overflow_bytes"] == st["dropped_bytes"]
            == rt._stream.dropped and audio and all(np.isfinite(a).all() for a in audio)):
        raise AssertionError("stream bank16 burst: drops not counted as whole chunks")
    serials["bank16 u8"] = (raw, wire, serial, to_card)


def stream_config4():
    """Config 4's ChannelizedBank (u8) over 'uint8_raw', a ring of 4 blocks,
    N_STREAM_PFB blocks pushed at the radio's 200 MB/s: no byte dropped,
    bit-equal to serial calls over the same blocks."""
    import torch
    from tpudsp_torch.chains import ChannelizedBank, ChannelizedBankConfig
    from tpudsp_torch.io import StreamRuntime
    u8 = wire_of(pfb_signal(PFB_DISTINCT, seed=44))["u8"].cpu().numpy()
    distinct = [u8[k * N_PFB:(k + 1) * N_PFB] for k in range(PFB_DISTINCT)]
    raw = [distinct[k % PFB_DISTINCT] for k in range(N_STREAM_PFB)]
    wire = b"".join(b.tobytes() for b in raw)
    to_card = lambda b: torch.from_numpy(b).to(DEV)
    make_rx = lambda: ChannelizedBank(ChannelizedBankConfig(), N_PFB, input_format="u8",
                                      device=DEV)
    serial, _ = _serial(make_rx(), raw, to_card)
    _, serial_s = _serial(make_rx(), raw, to_card)
    _cell("config4 u8 paced at 100 Msps",
          lambda: StreamRuntime(make_rx(), sample_format="uint8_raw", capacity_blocks=4),
          lambda rt, marks: _pusher(rt, wire, 2 * STREAM_CHUNK, PFB_WIRE_BPS, marks),
          N_STREAM_PFB, N_STREAM_PFB * N_PFB, serial, serial_s, PER_BLOCK["config4"])


def stream_concurrent(serials: dict):
    """The AM i16 and bank16 u8 runtimes pumping at once, each from its own
    producer thread: each bit-equal to its serial run (their launches are
    not counted: two pumps add to the wrappers' counts at once)."""
    from tpudsp_torch.chains import BankConfig, ReceiverBank
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.io import StreamRuntime
    rts = {"am i16": StreamRuntime(AMReceiver(AMConfig(), BLOCK_4M, "i16", device=DEV),
                                   sample_format="int16_raw", capacity_blocks=8),
           "bank16 u8": StreamRuntime(ReceiverBank(BankConfig(freqs=BANK_FREQS), N_BANK,
                                                   input_format="u8", device=DEV),
                                      sample_format="uint8_raw", capacity_blocks=8)}
    chunk = {"am i16": 4 * STREAM_CHUNK, "bank16 u8": 262144}
    threads = [threading.Thread(target=_push_all, args=(rt, serials[k][1], chunk[k]))
               for k, rt in rts.items()]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for rt in rts.values():
        rt.stop(drain=True)
    log(f"stream: two runtimes at once: {time.perf_counter() - t0:.3f} s")
    for k, rt in rts.items():
        _same_bits(f"{k}, beside the other runtime", list(rt), serials[k][2])


def stream_consumer(serials: dict, scratch: Path):
    """on_audio on the card: a WavSink and fm_stereo's metric reads; the
    file equals write_wav of the serial pcm; after stop(), the receiver's
    state saved, loaded into a fresh receiver, which then gives the
    original's next block bit for bit."""
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.io import StreamRuntime, WavSink, write_wav
    from tpudsp_torch.io.checkpoint import load_state, save_state
    raw, wire, serial, to_card = serials["am c64"]
    rx = AMReceiver(AMConfig(), BLOCK_4M, device=DEV)
    levels = []
    with WavSink(str(scratch / "stream.wav"), 48_000) as sink:
        def on_audio(pcm, meta):
            sink(pcm)
            m = meta["metrics"]
            levels.append((float(m.rssi), float(m.pll_freq)))
        rt = StreamRuntime(rx, on_audio=on_audio, capacity_blocks=8)
        _push_all(rt, wire, 4 * STREAM_CHUNK)
        rt.stop(drain=True)
        save_state(str(scratch / "am.npz"), rx.state)
    write_wav(str(scratch / "serial.wav"), np.concatenate(serial), 48_000)
    same = (scratch / "stream.wav").read_bytes() == (scratch / "serial.wav").read_bytes()
    log(f"stream: on_audio WavSink, {len(levels)} blocks (rssi, pll_freq per block "
        f"{levels}): file equal to write_wav of the serial pcm {same}")
    if not (same and len(levels) == N_STREAM_AM):
        raise AssertionError("stream: the WavSink's file differs")
    rx2 = AMReceiver(AMConfig(), BLOCK_4M, device=DEV)
    rx2.state = load_state(str(scratch / "am.npz"), rx2.state)
    nxt = to_card(raw[N_STREAM_AM])
    a, b = rx(nxt).cpu().numpy(), rx2(nxt).cpu().numpy()
    _same_bits("checkpoint after stop(), the next block: resumed vs original", [b], [a])


def stream_examples(scratch: Path):
    """Every examples_torch/*.py once, all at once, each a process of its
    own in a scratch directory: exit code 0."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}

    def run(script: Path):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(script)], cwd=scratch, env=env,
                             capture_output=True, text=True, timeout=600)
        return script.name, res, time.perf_counter() - t0
    scripts = sorted((ROOT / "examples_torch").glob("*.py"))
    with ThreadPoolExecutor(len(scripts)) as ex:
        runs = list(ex.map(run, scripts))
    for name, res, secs in runs:
        tail = (res.stdout.strip().splitlines() or [""])[-1]
        log(f"stream: examples_torch/{name}: exit {res.returncode} in {secs:.1f} s: {tail}")
        if res.returncode != 0:
            log(res.stderr[-3000:])
    if any(res.returncode for _, res, _ in runs):
        raise AssertionError("stream: an example failed")


def phase_stream():
    """The io runtime on the card: StreamRuntime, the ingest ring,
    RadioSource and the mock driver, WavSink, checkpoints, the examples."""
    import tempfile
    serials: dict = {}
    stream_am(serials)
    stream_bank16(serials)
    stream_config4()
    stream_concurrent(serials)
    with tempfile.TemporaryDirectory() as d:
        stream_consumer(serials, Path(d))
        stream_examples(Path(d))
    log(f"timing: stream: {json.dumps(results.get('stream', {}))}")


RADIO_STAGES = ("bandpass", "resample", "agc", "am", "audio_filter")


def _timed_call(fn, times: list):
    """fn, appending the host seconds of each call to ``times``."""
    def call(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        times.append(time.perf_counter() - t0)
        return out
    return call


def _block_times(rx, blocks):
    """Host seconds of rx on blocks[1:] after a warm-up call on blocks[0],
    each ending synchronised: (median, spread / median)."""
    import torch
    rx(blocks[0])
    torch.cuda.synchronize()
    times = []
    for b in blocks[1:]:
        t0 = time.perf_counter()
        rx(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med


def _block_device_ms(rx, blocks):
    """Median CUDA-event time of rx on blocks[1:] (ms), each call between
    two events on the current stream, after a warm-up call on blocks[0]."""
    import torch
    rx(blocks[0])
    times = []
    for b in blocks[1:]:
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        rx(b)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def profile_block(rx, blocks):
    """One torch.profiler window (CPU and CUDA activity) over rx(blocks[1])
    after a warm-up call on blocks[0]: the device activities (kernels,
    copies, sets; not the host's spans) in the window, their busy time
    (the union of their intervals) and its share of the window, from the
    first event to the last, and the device time of the eight busiest
    kernels by name. Windows like it once missed the block's first kernel
    (the bank's front, the AM block's front matmul); with torch 2.11 on
    the H100 machine the bank's front is there (bank16_traced_launches
    holds it), but read the busy time as a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rx(blocks[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rx(blocks[1])
        torch.cuda.synchronize()
    return device_busy(list(prof.events()))


def device_busy(events) -> dict:
    """Of a profiler window's events: the device activities (kernels,
    copies, sets; not the host's spans), their busy time (the union of
    their intervals) and its share of the window, from the first event to
    the last, and the device time of the eight busiest kernels by name."""
    from torch.autograd import DeviceType
    # the device's own activities: a record_function span (ReceiverBank.step)
    # also shows on the device's timeline, under its host-side name
    host = {e.name for e in events if e.device_type != DeviceType.CUDA}
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host]
    dev = sorted((e.time_range.start, e.time_range.end) for e in on_dev)
    busy, end = 0.0, float("-inf")
    for t0, t1 in dev:      # the union of the device intervals
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) if events else 0.0
    by_name: dict = {}
    for e in on_dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # a list, not a dict keyed by a cut name: template instances of one
    # kernel share their first characters
    return {"device_activities": len(dev), "busy_ms": busy / 1e3, "window_ms": span / 1e3,
            "busy_share": busy / span if span else None,
            "top_kernels_ms": [[k[:100], v / 1e3] for k, v in top]}


def profile_am_block():
    """AMReceiver(AMConfig()) on 4M-sample c64 blocks: the host-clock
    median of 5 with its spread, the CUDA-event median of 5, and
    profile_block's window."""
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    blocks = [torch.from_numpy(b).to(DEV) for b in wire_blocks(6, BLOCK_4M, seed=3)["c64"]]
    rx = AMReceiver(AMConfig(), BLOCK_4M, device=DEV)
    med, spread = _block_times(rx, blocks)
    return {"host_ms": med * 1e3, "host_spread": spread,
            "cuda_event_ms": _block_device_ms(rx, blocks), **profile_block(rx, blocks)}


def biquad_cases():
    """biquad_scan's two shapes: (label, design, state, x) for CLowpassIIR(
    order=8, Fc=0.0075, mode="scan") on a 2^18-sample complex64 callback
    (its main shape) and BroadcastAM's DC block on the callback's 6291 real
    samples, from zero states."""
    import torch
    sos, dc = clowpass_scan_sos(), dc_block_sos()
    xr = noise_c64(N_CALLBACK_OUT, 22).real + 1.0
    return [(f"CLowpassIIR c64 n={N_SURFACE}", sos,
             torch.zeros((len(sos), 2), dtype=torch.complex64, device=DEV),
             torch.from_numpy(noise_c64(N_SURFACE, 21)).to(DEV)),
            (f"DC block f32 n={N_CALLBACK_OUT}", dc, torch.zeros((len(dc), 2), device=DEV),
             torch.from_numpy(xr.astype(np.float32)).to(DEV))]


def biquad_bound(sos, x):
    """(bytes, operations) that biquad_scan's function needs: x in, y out,
    OPS_BIQUAD a sample, row and section."""
    rows = 2 if x.is_complex() else 1
    return x.numel() * x.element_size() * 2, x.shape[0] * rows * len(sos) * OPS_BIQUAD


def kernel_call_times():
    """CUDA-event times (ms) of first_order_scan, halo_async and
    biquad_scan, with whatever tpudsp_torch is imported (this tree's, or
    --profile-root's): first_order_scan by the wrapper's call (linear_tail
    at n = 96000, one recurrence at n = 96000 and at the AMRadio callback's
    6291), halo_async at the AM and bank shapes by the wrapper's call and
    by its two launches alone (taps packed and output allocated
    beforehand), and biquad_scan at biquad_cases' shapes (the table made
    beforehand) by the wrapper's call and its kernel's device time. Uses
    only entry points that the package has had since biquad_scan's
    port."""
    import torch
    from tpudsp_torch.cuda import biquad_scan, first_order, halo_async
    from tpudsp_torch.kernels import iir as kiir
    from tpudsp_torch.parallel import make_mesh
    vr = first_order_inputs(N_OUT_4M, seed=1)
    tp = tail_params(True)
    y0 = torch.zeros((), device=DEV)
    out = {f"linear_tail n={N_OUT_4M}": _cuda_ms(lambda: first_order.linear_tail(tp, y0, y0, vr), 20)}
    for n in (N_OUT_4M, N_CALLBACK_OUT):
        out[f"first_order n={n}"] = _cuda_ms(lambda: first_order.first_order_apply_blocked(
            1.0 - DC_RHO, DC_RHO, y0, vr[:n]), 20)
    mesh = make_mesh(1, 1, DEV)
    for label, case in (("AM shape c64", halo_am_case(7)),
                        ("bank shape c64", halo_bank_case("c64", 8))):
        x, tail, Tre, Tim, D1, nj = case
        taps = halo_async.pack_taps(Tre, Tim)
        y = torch.empty((Tre.shape[0], nj), dtype=torch.complex64, device=DEV)
        S = halo_async.boundary(tail.shape[0], D1, nj)

        def launches():
            halo_async._launch(x, tail, taps, y, D1, S, nj)
            halo_async._launch(x, tail, taps, y, D1, 0, S)
        out[f"halo_async {label} call"] = _cuda_ms(
            lambda: halo_async.bank_front_async(*case, mesh), 20)
        out[f"halo_async {label} launches"] = _cuda_ms(launches, 20)
    for label, sos, st, xb in biquad_cases():
        tab = torch.from_numpy(kiir.sos_table(sos)).to(DEV)
        call = lambda: biquad_scan.sos_apply_df(tab, st, xb)
        out[f"biquad_scan {label}"] = _cuda_ms(call, 20)
        out[f"biquad_scan {label} device"] = _device_ms(call, "biquad_scan_kernel", 20)
    return out


def _conv1d_call(x, tail, Tre, Tim, D1, nj):
    """The library call for halo_async's function: one strided
    torch.nn.functional.conv1d over the (re, im) planes of [tail | x |
    pad] (centred as the kernel loads them): with complex taps one
    2-channel input and 2C real filters [Tr, -Ti] and [Ti, Tr]; with real
    taps (Tim None) a batch of the two planes and the C filters Tr. Timed
    beside the kernel; the port never calls it. Returns (the call, its
    output as (C, nj) complex)."""
    import torch
    from tpudsp_torch.cuda.halo_async import _FORMATS
    _, off, pad_value = _FORMATS[x.dtype]
    C, Kc, _ = Tre.shape
    win = Kc * D1
    X = torch.cat([tail, x])
    pad = (nj - 1) * D1 + win - X.shape[0]
    if pad > 0:
        X = torch.cat([X, torch.full((pad,) + X.shape[1:], pad_value, dtype=X.dtype,
                                     device=X.device)])
    planes = (torch.view_as_real(X) if X.is_complex() else X.float() - off).T
    Tr = Tre.reshape(C, win)
    if Tim is None:
        planes, W = planes[:, None].contiguous(), Tr[:, None].contiguous()
        return (lambda: torch.nn.functional.conv1d(planes, W, stride=D1),
                lambda y: torch.complex(y[0], y[1]))
    Ti = Tim.reshape(C, win)
    W = torch.stack([torch.stack([Tr, -Ti], 1), torch.stack([Ti, Tr], 1)], 1)
    W = W.reshape(2 * C, 2, win)
    planes = planes[None].contiguous()
    return (lambda: torch.nn.functional.conv1d(planes, W, stride=D1),
            lambda y: torch.complex(y[0, 0::2], y[0, 1::2]))


def time_halo_async(calls):
    """halo_async's bound and the conv1d library call's time (TF32 off) at
    the AM shape, and conv1d at the bank shape, beside the kernel's times
    in ``calls`` (kernel_call_times)."""
    import torch
    from tpudsp_torch.cuda import halo_async
    from tpudsp_torch.parallel import make_mesh
    mesh = make_mesh(1, 1, DEV)
    torch.backends.cudnn.allow_tf32 = False
    cases = [("AM shape c64", halo_am_case(7)), ("bank shape c64", halo_bank_case("c64", 8))]
    k = results["kernels"]["halo_async"]
    for label, case in cases:
        x, tail, Tre, Tim, D1, nj = case
        conv, to_complex = _conv1d_call(*case)
        y_conv = to_complex(conv())
        Y = halo_async.bank_front_async(*case, mesh)
        C = Tre.shape[0]
        s = snr_db(Y.cpu().numpy(), y_conv.cpu().numpy())
        library_ms = _cuda_ms(conv, 20)
        taps = tap_count(Tre, Tim)
        # real taps: 2 multiplies and 2 adds per tap and output (4 B a
        # tap); complex: 8 (8 B a tap)
        per_tap = 4 if Tim is None else 8
        nbytes = (x.numel() + tail.numel()) * x.element_size() + taps * per_tap + nj * C * 8
        ops = float(per_tap) * taps * nj
        call_ms = calls[f"halo_async {label} call"]
        log(f"timing: halo_async {label}: wrapper call {call_ms:.4f} ms, its two launches "
            f"alone {calls[f'halo_async {label} launches']:.4f} ms, conv1d {library_ms:.4f} ms "
            f"(agrees with the kernel to {s:.1f} dB), bound max({nbytes / HBM_BPS * 1e3:.4f}, "
            f"{ops / F32_FLOPS * 1e3:.4f}) ms")
        if label.startswith("AM"):
            k.update(ms=call_ms, library_ms=library_ms)
            bound("halo_async", nbytes, ops)


def phase_timing():
    import torch
    import tpudsp_torch.compat as liquiddsp
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.cuda import agc_scan, first_order, pll_scan
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.kernels import agc as kagc
    from tpudsp_torch.kernels import lanes
    from tpudsp_torch.kernels import pll as kpll
    from tpudsp_torch.cuda import halo_async
    from tpudsp_torch.parallel import ShardedAMReceiver, make_mesh
    counts = read_counts()
    data = wire_blocks(6, BLOCK_4M, seed=3)     # a distinct block every call
    for fmt in ("c64", "i16", "u8"):
        rx = AMReceiver(AMConfig(), BLOCK_4M, fmt, device=DEV)
        gpu = [torch.from_numpy(b).to(DEV) for b in data[fmt]]
        med, spread = _block_times(rx, gpu)
        dev_ms = _block_device_ms(rx, gpu)
        log(f"timing: AMReceiver {fmt} 4M-sample block: median {med * 1e3:.3f} ms "
            f"of 5 (spread {spread * 100:.1f}%), {BLOCK_4M / med / 1e6:.1f} Msamp/s; "
            f"CUDA events median {dev_ms:.3f} ms of 5")
    prof = profile_am_block()
    log(f"timing: profiler and block times, AMReceiver c64 4M-sample block: "
        f"{json.dumps(prof)}")
    calls = kernel_call_times()
    log(f"timing: first_order_scan, halo_async and biquad_scan times: {json.dumps(calls)}")
    if PARENT:
        # the same with the parent's package, in a process of its own
        log(f"timing: profiler and block times, the parent's AMReceiver c64 4M-sample "
            f"block, and its first_order_scan, halo_async and biquad_scan times: "
            f"{json.dumps(parent_report('--profile-root'))}")
    blocks = [torch.from_numpy(b).to(DEV) for b in data["c64"]]
    for halo in ("ppermute", "async"):
        rx = ShardedAMReceiver(AMConfig(), make_mesh(1, 1, DEV), BLOCK_4M, halo=halo,
                               device=DEV)
        med, spread = _block_times(rx, blocks)
        log(f"timing: ShardedAMReceiver 1x1 halo={halo} c64 4M-sample block: median "
            f"{med * 1e3:.3f} ms of 5 (spread {spread * 100:.1f}%), "
            f"{BLOCK_4M / med / 1e6:.1f} Msamp/s")
    # the AMRadio per callback (bytes in, pcm out), a distinct callback
    # each; each stage's call is timed too (each returns numpy, so each
    # ends synchronised with the card)
    radio = am_radio_class(liquiddsp)()
    stages = {s: [] for s in ("bytes_to_iq", *RADIO_STAGES)}
    for s in RADIO_STAGES:
        setattr(radio, s, _timed_call(getattr(radio, s), stages[s]))
    b2iq = _timed_call(liquiddsp.bytes_to_iq, stages["bytes_to_iq"])
    cbs = results["callbacks"]
    radio(b2iq(cbs[0]))
    times = []
    for cb in cbs[1:6]:
        t0 = time.perf_counter()
        radio(b2iq(cb))
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"timing: README AMRadio callback of {CALLBACK} samples: median "
        f"{med * 1e3:.3f} ms of 5 (spread {(max(times) - min(times)) / med * 100:.1f}%), "
        f"{CALLBACK / med / 1e6:.1f} Msamp/s; per stage (median of 5, ms): "
        + ", ".join(f"{s} {statistics.median(v[1:]) * 1e3:.3f}"
                    for s, v in stages.items()))

    k = results["kernels"]
    x, x4, xc = (results["inputs"][n] for n in ("x96k", "x4m", "xc"))
    p, st = front_params(), front_state(1)
    k["am_front_scan"]["ms"] = _cuda_ms(
        lambda: scan.front_chunked(p, st, x, CHUNK, WARMUP), 20)
    k["am_front_scan"]["steps_per_lane"] = WARMUP + CHUNK
    bound("am_front_scan", N_OUT_4M * (8 + 4 + 4), N_OUT_4M * (OPS_AGC + OPS_PLL))
    entry = x[:, :WARMUP].contiguous()
    entry_ms = _cuda_ms(lambda: scan.front_exact(p, st, entry), 10)
    ap = kagc.make_params(alpha=0.01, scale=0.01, device=DEV)
    ast = agc_state(1)
    k["agc_scan"]["ms"] = _cuda_ms(lambda: agc_scan.agc_chunked_pallas(
        ap, ast, x4, AGC_CHUNK, AGC_WARMUP), 10)
    k["agc_scan"]["steps_per_lane"] = AGC_WARMUP + AGC_CHUNK
    bound("agc_scan", BLOCK_4M * (8 + 8 + 4), BLOCK_4M * OPS_AGC)
    k["agc_scan exact"]["ms"] = _cuda_ms(lambda: agc_scan.agc_exact(ap, ast, xc), 10)
    k["agc_scan exact"]["steps_per_lane"] = N_CALLBACK_OUT
    z = lambda: torch.zeros(1, device=DEV)
    pst = kpll.PllState(z(), z())
    k["pll_scan"]["ms"] = _cuda_ms(lambda: pll_scan.pll_carrier_scan(pst, xc, 0.001), 10)
    k["pll_scan"]["steps_per_lane"] = N_CALLBACK_OUT
    bound("pll_scan", N_CALLBACK_OUT * (8 + 4), N_CALLBACK_OUT * OPS_PLL)
    pll96 = _cuda_ms(lambda: pll_scan.pll_carrier_scan(pst, x, 0.001), 5)
    # first_order_scan: the AM receiver's tail, one linear_tail_scan launch
    # at its shape; its steps are 2 x 3000 blocks (the sequential carry's
    # dependent double-float steps, now a scan per tile)
    k["first_order_scan"]["ms"] = calls[f"linear_tail n={N_OUT_4M}"]
    k["first_order_scan"]["steps_per_lane"] = 2 * (-(-N_OUT_4M // 32))
    bound("first_order_scan", N_OUT_4M * (4 + 4), N_OUT_4M * 2 * OPS_FIRST_ORDER)
    one = {n: calls[f"first_order n={n}"] for n in (N_OUT_4M, N_CALLBACK_OUT)}
    # the two staged kernels' launches alone, on planes made beforehand: the
    # rest of a wrapper call is its plain PyTorch copies (planes, outputs,
    # the ragged tail's fix)
    fre, fim, fn, _ = lanes.planes(x, CHUNK)
    are, aim, an, _ = lanes.planes(x4, AGC_CHUNK)
    alone = {"am_front_scan": (_cuda_ms(lambda: scan._launch(p, st, fre, fim, fn, WARMUP), 20),
                               WARMUP + CHUNK),
             "agc_scan": (_cuda_ms(lambda: agc_scan._launch(ap, ast, are, aim, an, AGC_WARMUP),
                                   10), AGC_WARMUP + AGC_CHUNK)}
    time_halo_async(calls)
    # biquad_scan at its main shape (CLowpassIIR(order=8, Fc=0.0075,
    # mode="scan") on 2^18 complex64 samples, 4 sections of 2 rows) and at
    # BroadcastAM's DC block (6291 real samples, 2 sections)
    (main, sos, _, bx), (dc_label, dc, _, dx) = biquad_cases()
    k["biquad_scan"]["ms"] = calls[f"biquad_scan {main}"]
    bound("biquad_scan", *biquad_bound(sos, bx))
    nbytes, ops = biquad_bound(dc, dx)
    dc_bound = max(nbytes / HBM_BPS, ops / F32_FLOPS) * 1e3
    for label, bound_ms in ((main, k["biquad_scan"]["bound_ms"]), (dc_label, dc_bound)):
        ms, dev_ms = calls[f"biquad_scan {label}"], calls[f"biquad_scan {label} device"]
        log(f"timing: biquad_scan {label}: wrapper call {ms:.4f} ms, kernel on the device "
            f"{dev_ms:.4f} ms, bound {bound_ms:.7f} ms, {dev_ms / bound_ms:.1f}x by the device")
    log(f"timing: biquad_scan {dc_label} (BroadcastAM's DC block): bound bytes "
        f"{nbytes / HBM_BPS * 1e3:.7f} ms, operations {ops / F32_FLOPS * 1e3:.7f} ms")
    # the complex64 call at FMStereo's pilot smoother shape (2^18 samples)
    ab, cyp, cx = results["inputs"]["c64"]
    k["first_order_scan_c64"]["ms"] = _cuda_ms(
        lambda: first_order.first_order_apply_blocked_c64(*ab, cyp, cx), 20)
    bound("first_order_scan_c64", cx.shape[0] * (8 + 8), cx.shape[0] * 2 * OPS_FIRST_ORDER)
    # timing launches are not a path's
    for name, fn in _counters().items():
        fn.launches = counts[name]
    for name, v in k.items():
        steps = v.get("steps_per_lane")
        v["ns_per_step"] = v["ms"] * 1e6 / steps if steps else None
        log(f"timing: {name}: kernel {v['ms']:.4f} ms, plain PyTorch "
            f"{v['plain_ms']:.1f} ms, bound {v.get('bound_ms', float('nan')):.6f} ms, "
            f"library {v.get('library_ms')}, steps/lane {steps}, "
            f"ns/step {v['ns_per_step']}")
    log(f"timing: pll_scan exact L={N_OUT_4M}: kernel {pll96:.4f} ms, "
        f"ns/step {pll96 * 1e6 / N_OUT_4M:.1f}")
    log(f"timing: am_front_scan entry scan (exact, L={WARMUP}): kernel {entry_ms:.4f} ms, "
        f"ns/step {entry_ms * 1e6 / WARMUP:.1f}")
    for n, ms in one.items():
        log(f"timing: first_order_scan one recurrence (DC tracker) n={n}: wrapper call "
            f"{ms:.4f} ms, ns per block {ms * 1e6 / -(-n // 32):.1f}")
    for name, (ms, steps) in alone.items():
        log(f"timing: {name} launch alone at its main shape: {ms:.4f} ms, "
            f"ns/step {ms * 1e6 / steps:.1f} (the wrapper's call: {k[name]['ms']:.4f} ms)")


PHASES = [("build", phase_build), ("kernel", phase_kernel), ("chain", phase_chain),
          ("width", phase_width), ("sharded", phase_sharded), ("compat", phase_compat),
          ("options", phase_options), ("surface", phase_surface),
          ("receivers", phase_receivers), ("channelizer", phase_channelizer),
          ("parallel", phase_parallel), ("stream", phase_stream), ("timing", phase_timing)]

KERNELS = [
    ("am_front_scan", "tpudsp_torch/csrc/am_front_scan.cu",
     "tpudsp/pallas/am_backend_scan.py:41"),
    ("agc_scan", "tpudsp_torch/csrc/agc_scan.cu", "tpudsp/pallas/agc_scan.py:37"),
    # a lax.scan in the JAX package, not a Pallas kernel
    ("pll_scan", "tpudsp_torch/csrc/pll_scan.cu", "tpudsp/kernels/pll.py:45"),
    ("halo_async", "tpudsp_torch/csrc/halo_async.cu", "tpudsp/pallas/halo_async.py:43"),
    # an einsum and a lax.scan in the JAX package, not a Pallas kernel
    ("first_order_scan", "tpudsp_torch/csrc/first_order_scan.cu", "tpudsp/kernels/iir.py:283"),
    # the same, with a complex64 lax.scan carry: an entry of the same source
    ("first_order_scan_c64", "tpudsp_torch/csrc/first_order_scan.cu",
     "tpudsp/kernels/iir.py:343"),
    # an associative scan of double-float 2x2 maps, not a Pallas kernel
    ("biquad_scan", "tpudsp_torch/csrc/biquad_scan.cu", "tpudsp/kernels/iir.py:212"),
    # T shifted multiply-adds that XLA fuses, not a Pallas kernel
    ("pfb_branch", "tpudsp_torch/csrc/pfb_branch.cu", "tpudsp/chains/channelizer.py:185"),
    # an einsum over column blocks and a lax.scan: the column entry of
    # first_order_scan.cu, first_order_scan_cols
    ("first_order_scan_mc", "tpudsp_torch/csrc/first_order_scan.cu",
     "tpudsp/kernels/iir.py:381"),
    # the FM bank's discriminator in XLA, then the same einsum and scan:
    # the column kernel's FM instance, fm_deemph_cols
    ("fm_deemph_cols", "tpudsp_torch/csrc/first_order_scan.cu",
     "tpudsp/chains/channelizer.py:368"),
    # the receiver bank's phase lattice, rotation and discriminator in XLA:
    # not a Pallas kernel
    ("bank_rotate", "tpudsp_torch/csrc/bank_rotate.cu", "tpudsp/chains/bank.py:304"),
]


def main() -> int:
    global PARENT
    ap = argparse.ArgumentParser(description="Drive tpudsp_torch on one CUDA device.")
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit to hold "
                    "pll_scan's bits, the AM block's launches and times, and "
                    "first_order_scan's, halo_async's and biquad_scan's times against")
    ap.add_argument("--profile-root", type=Path, help="print one AM block's times and "
                    "profiler window, and first_order_scan's, halo_async's and biquad_scan's "
                    "call times, with the package under this checkout, and exit")
    ap.add_argument("--channelizer-root", type=Path, help="print the config 4 paths' block "
                    "times with the package under this checkout, and exit")
    args = ap.parse_args()
    if not (ROOT / "tpudsp_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(tpudsp_torch/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    if args.profile_root:
        # an AM block's times and one profiler window with the package
        # under the given root, for --parent; prints one JSON line
        sys.path.insert(0, str(args.profile_root.resolve()))
        print(json.dumps({**profile_am_block(), "calls": kernel_call_times()}))
        return 0
    if args.channelizer_root:
        sys.path.insert(0, str(args.channelizer_root.resolve()))
        print(json.dumps(channelizer_block_times()))
        return 0
    PARENT = args.parent.resolve() if args.parent else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"
    versions = (f"torch {torch.__version__} cuda {torch.version.cuda} "
                f"python {sys.version.split()[0]}")
    log(card)
    sys.path.insert(0, str(ROOT))
    log(versions)
    failed = []
    for name, fn in PHASES:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAILED")
            if name == "build":
                break
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke.py: failed phases: {failed}", file=sys.stderr)
        return 1
    # the card and versions again, where the end of a long log keeps them
    log(f"{card}; {versions}")
    k = results["kernels"]
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": k[name].get("launches", 0), "max_abs_err": k[name]["max_abs_err"],
        "ms": k[name]["ms"], "plain_ms": k[name]["plain_ms"],
        "bound_ms": k[name]["bound_ms"], "bound_by": k[name]["bound_by"],
        "library_ms": k[name].get("library_ms"),
        "steps_per_lane": k[name].get("steps_per_lane"),
        "ns_per_step": k[name].get("ns_per_step")} for name, source, replaces in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
