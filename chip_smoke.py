#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpudsp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit. Phases, each of which fails the run (exit code 1, no final
result line) if it fails:

1. build   -- compile every kernel of the port from csrc/ with nvcc, in
              parallel, and print the seconds it took;
2. kernel  -- the CUDA front-scan kernel against its plain PyTorch version
              on the card: the main path's shape (one stream, 96000 samples,
              chunk = warmup = 3840), a ragged 3-stream batch with squelch
              on, and a short block (the exact single-lane launch). vr must
              reach 90 dB SNR, modes must be equal, final states close;
3. chain   -- AMReceiver on the card over two 2M-sample blocks against the
              float64 sample-serial oracle chain (numpy, on the host):
              >= 100 dB over the settled second half;
4. width   -- the main path at full width: AMReceiver on 4M-sample blocks
              (the largest block of the JAX package's bench), three blocks
              with carried state, for c64, i16 and u8 input; i16/u8 >= 90 dB
              against c64, all finite, every kernel launched (launch counts
              are zeroed just before and read just after this phase);
5. timing  -- per-format block time (median of 5 with spread) and the
              kernel against its plain version at the phase-2 main shape.

Prints the card's name and power limit first, a "kernels" JSON line before
the last, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without that line when no CUDA device is present or when it
is run outside a checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CHUNK = WARMUP = 3840       # the main path's chunk and warmup (default AMConfig)
N_OUT_4M = 96_000           # pcm samples of one 4M-sample block

results: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def snr_db(ref, test) -> float:
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(test, np.float64)
    p_err = np.mean(err ** 2)
    return float("inf") if p_err == 0 else float(10 * np.log10(np.mean(ref ** 2) / p_err))


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


def oracle_am_chain(iq, cfg):
    """The float64 sample-serial oracle chain of tests/test_chain_snr.py
    (bandpass -> resample -> AGC -> PLL AM demod with DC tracker ->
    de-emphasis); the bandpass runs as scipy's sosfilt, the same
    transposed direct form II recurrence as SosFilterOracle."""
    import importlib.util
    import scipy.signal as sig
    from tpudsp_torch.design import firdes, iirdes
    # loaded by path: an installed package named "tests" may shadow the repo's
    spec = importlib.util.spec_from_file_location(
        "liquid_oracle", ROOT / "tests" / "oracle" / "liquid_oracle.py")
    lo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lo)
    AgcOracle, FirstOrderOracle, ResampOracle = lo.AgcOracle, lo.FirstOrderOracle, lo.ResampOracle
    sos = iirdes.iirdes_sos("cheby2", "lowpass", cfg.order,
                            cfg.bandwidth / cfg.iq_rate, As=60.0, Ap=0.5)
    bb = sig.sosfilt(sos, np.asarray(iq, np.complex128))
    H = firdes.resamp_bank(cfg.resamp_m, 0.45 * cfg.rate, 60.0, cfg.resamp_npfb)
    agc = AgcOracle(bandwidth=cfg.agc_bandwidth)
    agc.scale = cfg.agc_scale
    agc.sq_mode = 7  # squelch disabled
    y, _ = agc(ResampOracle(H, cfg.rate, complex_data=True)(bb))
    theta, freq, dc = 0.0, 0.0, 0.0
    alpha, beta, rho = 0.001, np.sqrt(0.001), 0.9995
    out = np.empty(len(y))
    for n in range(len(y)):
        v = y[n] * np.exp(-1j * theta)
        err = np.angle(v) if abs(v) > 0 else 0.0
        freq += alpha * err
        theta = (theta + beta * err + freq + np.pi) % (2 * np.pi) - np.pi
        dc = rho * dc + (1 - rho) * v.real
        out[n] = (v.real - dc) / cfg.modulation
    return FirstOrderOracle(*iirdes.deemphasis_coeffs(cfg.pcm_rate))(out)


def front_params(squelch=False, threshold=0.0):
    import torch
    from tpudsp_torch.kernels import agc as kagc
    from tpudsp_torch.kernels import am_backend as kab
    agcp = kagc.make_params(alpha=0.01, scale=0.01, squelch=squelch,
                            threshold=threshold, device="cuda")
    return kab.make_params(agcp, torch.tensor(0.5, device="cuda"), 0.05, 0.95,
                           carrier=True)


def front_state(C: int, squelch=False):
    import torch
    from tpudsp_torch.kernels import agc as kagc
    from tpudsp_torch.kernels import am_backend as kab
    a0 = kagc.agc_init(squelch=squelch, device="cuda")
    z = lambda: torch.zeros(C, device="cuda")
    return kab.FrontState(kagc.AgcState(*(v.expand(C).contiguous() for v in a0)),
                          kab.PllState(z(), z()))


# --------------------------------------------------------------------------
def phase_build():
    from tpudsp_torch.cuda import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SIGNATURES)) as ex:
        libs = list(ex.map(build.compile_source, build.SIGNATURES))
    for name in build.SIGNATURES:
        build.load(name)
    log(f"build: {len(libs)} kernel source(s) in {time.perf_counter() - t0:.2f} s")


def _compare(name, kernel_out, ref_out, snr_bar=90.0):
    """kernel vs plain front: vr SNR per stream, equal modes, close finals.
    Returns the max abs error of vr."""
    import torch
    (kf, (kvr, km)), (rf, (rvr, rm)) = kernel_out, ref_out
    torch.cuda.synchronize()
    kvr, rvr = kvr.cpu().numpy(), rvr.cpu().numpy()
    worst = min(snr_db(rvr[c], kvr[c]) for c in range(rvr.shape[0]))
    max_err = float(np.max(np.abs(kvr - rvr)))
    modes_equal = torch.equal(km.cpu(), rm.cpu())
    dtheta = np.angle(np.exp(1j * (kf.pll.theta.double().cpu().numpy()
                                   - rf.pll.theta.double().cpu().numpy())))
    live = ~np.isin(rf.agc.sq_mode.cpu().numpy(), [1, 5])
    g_rel = float(np.max(np.abs(kf.agc.g.cpu().numpy() / rf.agc.g.cpu().numpy() - 1)))
    fsm_equal = (torch.equal(kf.agc.sq_mode.cpu(), rf.agc.sq_mode.cpu())
                 and torch.equal(kf.agc.sq_timer.cpu(), rf.agc.sq_timer.cpu()))
    theta_err = float(np.max(np.abs(dtheta[live]), initial=0.0))
    log(f"kernel[{name}]: vr snr {worst:.2f} dB, max_abs_err {max_err:.3e}, "
        f"modes equal {modes_equal}, fsm state equal {fsm_equal}, "
        f"g rel err {g_rel:.2e}, theta err (live streams) {theta_err:.2e}")
    ok = (worst >= snr_bar and modes_equal and fsm_equal and g_rel < 1e-4
          and theta_err < 1e-3)
    if not ok:
        raise AssertionError(f"kernel[{name}] disagrees with its plain version")
    return max_err


def phase_kernel():
    import torch
    from tpudsp_torch.cuda import am_backend_scan as scan
    # main-path shape: one stream of 96000 pcm-rate samples (a 4M block)
    x = torch.from_numpy(am_signal(N_OUT_4M, 48_000.0, 200.0, noise=0.003,
                                   seed=1)[None]).cuda()
    p, st = front_params(), front_state(1)
    results["main_err"] = _compare(
        "main C=1 L=96000", scan.front_chunked(p, st, x, CHUNK, WARMUP),
        scan.front_chunked_ref(p, st, x, CHUNK, WARMUP))
    # ragged batch, squelch on: loud / quiet / loud-then-quiet streams with
    # settled rssi near -10 dB and -60 dB, far from the -35 dB threshold
    L = 50_000 - 77
    xs = np.stack([am_signal(L, 48_000.0, 150.0 * (c + 1), amp)
                   for c, amp in enumerate((0.3, 0.001, 0.3))])
    xs[2, L // 2:] *= 0.003
    xs = torch.from_numpy(xs).cuda()
    p, st = front_params(squelch=True, threshold=-35.0), front_state(3, squelch=True)
    _compare("ragged C=3 squelch", scan.front_chunked(p, st, xs, CHUNK, WARMUP),
             scan.front_chunked_ref(p, st, xs, CHUNK, WARMUP))
    # short block: L <= chunk + warmup runs the exact single-lane launch
    from tpudsp_torch.kernels import am_backend as kab
    xb = x[:, :5000].contiguous()
    p, st = front_params(), front_state(1)
    _compare("short C=1 L=5000", scan.front_chunked(p, st, xb, CHUNK, WARMUP),
             kab.front_exact(p, st, xb))


def phase_chain():
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    cfg = AMConfig()
    n, block = 4_000_000, 2_000_000
    iq = am_signal(n, cfg.iq_rate, 200.0)
    y_ref = oracle_am_chain(iq, cfg)
    rx = AMReceiver(cfg, block, device="cuda")
    y = torch.cat([rx(torch.from_numpy(iq[:block]).cuda()),
                   rx(torch.from_numpy(iq[block:]).cuda())]).cpu().numpy()
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
    block = 4_000_000
    data = wire_blocks(3, block, seed=2)
    rxs = {k: AMReceiver(AMConfig(), block, "c64" if k.startswith("c64") else k,
                         device="cuda") for k in data}
    gpu = {k: [torch.from_numpy(b).cuda() for b in v] for k, v in data.items()}
    torch.cuda.synchronize()
    scan._launch.launches = 0                      # the main path's run starts
    out = {k: torch.cat([rxs[k](b) for b in gpu[k]]) for k in data}
    torch.cuda.synchronize()
    launches = scan._launch.launches               # ... and ends
    results["launches"] = {"am_front_scan": launches}
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


def phase_timing():
    import torch
    from tpudsp_torch.chains.am import AMConfig, AMReceiver
    from tpudsp_torch.cuda import am_backend_scan as scan
    block = 4_000_000
    data = wire_blocks(6, block, seed=3)     # a distinct block every call
    rates = {}
    for fmt in ("c64", "i16", "u8"):
        rx = AMReceiver(AMConfig(), block, fmt, device="cuda")
        blocks = [torch.from_numpy(b).cuda() for b in data[fmt]]
        rx(blocks[0])
        torch.cuda.synchronize()
        times = []
        for b in blocks[1:]:
            t0 = time.perf_counter()
            rx(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        spread = (max(times) - min(times)) / med
        rates[fmt] = block / med
        log(f"timing: AMReceiver {fmt} 4M-sample block: median {med * 1e3:.3f} ms "
            f"of 5 (spread {spread * 100:.1f}%), {block / med / 1e6:.1f} Msamp/s")
    results["rates"] = rates
    x = torch.from_numpy(am_signal(N_OUT_4M, 48_000.0, 200.0, noise=0.003,
                                   seed=1)[None]).cuda()
    p, st = front_params(), front_state(1)
    before = scan._launch.launches
    ms = _cuda_ms(lambda: scan.front_chunked(p, st, x, CHUNK, WARMUP), 20)
    plain_ms = _cuda_ms(lambda: scan.front_chunked_ref(p, st, x, CHUNK, WARMUP), 1)
    scan._launch.launches = before    # timing launches are not the main path's
    results["ms"], results["plain_ms"] = ms, plain_ms
    log(f"timing: am_front_scan C=1 L={N_OUT_4M} chunk={CHUNK} warmup={WARMUP}: "
        f"kernel {ms:.4f} ms, plain PyTorch {plain_ms:.1f} ms")


PHASES = [("build", phase_build), ("kernel", phase_kernel), ("chain", phase_chain),
          ("width", phase_width), ("timing", phase_timing)]


def main() -> int:
    if not (ROOT / "tpudsp_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(tpudsp_torch/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    sys.path.insert(0, str(ROOT))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
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
    log(json.dumps({"kernels": [{
        "name": "am_front_scan", "route": "cuda",
        "source": "tpudsp_torch/csrc/am_front_scan.cu",
        "replaces": "tpudsp/pallas/am_backend_scan.py:41",
        "launches": results["launches"]["am_front_scan"],
        "max_abs_err": results["main_err"],
        "ms": results["ms"], "plain_ms": results["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
