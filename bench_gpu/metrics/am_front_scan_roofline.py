"""am_front_scan_roofline: the share of csrc/am_front_scan.cu's device time
that the least time for its function's work would take.

The work of the AGC + carrier-PLL front over ``samples`` complex samples:
16 bytes a sample (8 read, 4 of vr and 4 of modes written) and 45 f32
operations a sample (the AGC step's 25, the PLL step's 20), against the
card's peaks (peaks.json). The share is tiny by nature: 7680 dependent
steps a lane hold the kernel, and no byte count does."""

BYTES_PER_SAMPLE = 16
OPS_PER_SAMPLE = 45


def least_s(work: dict, peaks: dict) -> float:
    n = work["samples"]
    return max(n * BYTES_PER_SAMPLE / peaks["hbm_bytes_per_s"],
               n * OPS_PER_SAMPLE / peaks["f32_flops"])


def read(ctx):
    name = "am_front_scan"
    tr, work = ctx["trace"], ctx["work"]
    if not tr["counts_ok"] or name not in work:
        return None
    least = least_s(work[name], ctx["peaks"])
    spent = tr["hand"].get(name, {}).get("seconds", 0.0)
    if spent == 0.0:
        return None
    return 100.0 * least * ctx["blocks"] / spent
