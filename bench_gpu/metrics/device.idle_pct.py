"""device.idle_pct: the share of the traced window in which no device
operation ran, from the profiler's timeline."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
