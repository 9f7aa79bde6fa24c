"""halo_async_roofline: the share of csrc/halo_async.cu's device time that
the least time for its function's work would take.

The receiver bank's front end: C channels of a ``taps``-tap complex filter
over a block of N wire samples, decimating to nj outputs a channel. The
block and the carried tail of taps - 1 samples read once at the wire's
width, the (C, nj) complex64 outputs written once, and 8 f32 operations an
output and tap (a complex multiply-add), counting the function's own taps
and not the zeros that pad them to whole frames, against the card's peaks
(peaks.json)."""

OPS_PER_OUTPUT_TAP = 8


def least_s(work: dict, peaks: dict) -> float:
    C, taps, N, nj, wb = work["C"], work["taps"], work["N"], work["nj"], work["wire_bytes"]
    nbytes = (N + taps - 1) * wb + C * nj * 8
    return max(nbytes / peaks["hbm_bytes_per_s"],
               OPS_PER_OUTPUT_TAP * C * nj * taps / peaks["f32_flops"])


def read(ctx):
    name = "halo_async"
    tr, work = ctx["trace"], ctx["work"]
    if not tr["counts_ok"] or name not in work:
        return None
    least = least_s(work[name], ctx["peaks"])
    spent = tr["hand"].get(name, {}).get("seconds", 0.0)
    if spent == 0.0:
        return None
    return 100.0 * least * ctx["blocks"] / spent
