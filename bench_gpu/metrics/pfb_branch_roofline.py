"""pfb_branch_roofline: the share of csrc/pfb_branch.cu's device time that
the least time for its function's work would take.

The branch sum of C branches of T taps over a block of N wire samples
(critically sampled: N / C frames): the block and the carried tail of
(T-1) C + C-1 samples read once at the wire's width, the (N / C, C)
complex64 u written once, and 4 f32 operations a sample and tap, against
the card's peaks (peaks.json)."""

OPS_PER_SAMPLE_TAP = 4


def least_s(work: dict, peaks: dict) -> float:
    C, T, N, wb = work["C"], work["T"], work["N"], work["wire_bytes"]
    nbytes = (N + (T - 1) * C + C - 1) * wb + (N // C) * C * 8
    return max(nbytes / peaks["hbm_bytes_per_s"], OPS_PER_SAMPLE_TAP * N * T / peaks["f32_flops"])


def read(ctx):
    name = "pfb_branch"
    tr, work = ctx["trace"], ctx["work"]
    if not tr["counts_ok"] or name not in work:
        return None
    least = least_s(work[name], ctx["peaks"])
    spent = tr["hand"].get(name, {}).get("seconds", 0.0)
    if spent == 0.0:
        return None
    return 100.0 * least * ctx["blocks"] / spent
