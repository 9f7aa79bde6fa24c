"""am_front_scan.ns_per_step: csrc/am_front_scan.cu's device time in the
traced window over the dependent steps a lane its launches ran there, in
ns: the time of one step of the AGC + carrier-PLL chain, which a roofline
share of the kernel cannot track.

The steps come from the wrapper's counter ``_launch.steps`` (chunk +
warmup a chunked launch, L an exact one) over its ``_launch.launches``,
times the launches in the trace: every block of a cell launches the same
shapes. A program without the counter gives no number."""


def read(ctx):
    tr = ctx["trace"]
    spent = tr["hand"].get("am_front_scan", {})
    if not tr["counts_ok"] or not spent.get("trace"):
        return None
    try:
        from tpudsp_torch.cuda.am_backend_scan import _launch
    except ImportError:
        return None
    steps = getattr(_launch, "steps", 0)
    if not steps or not _launch.launches:
        return None
    return spent["seconds"] * 1e9 / (spent["trace"] * steps / _launch.launches)
