"""chain.launches: device kernels a block (copies and sets not counted), by
the profiler's kernel count over the traced blocks. The harness holds each
hand kernel's count in the trace against its wrapper's launch counter;
with a count short, the metric is left out."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["counts_ok"]:
        return None
    return tr["kernels"] / ctx["blocks"]
