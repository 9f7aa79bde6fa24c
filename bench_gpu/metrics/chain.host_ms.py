"""chain.host_ms: the host's time inside the entry call a block (its
enqueue, before the sync), by the harness's clock around the call, as the
mean over every block of the measured window."""


def read(ctx):
    return ctx["host_ms"]
